"""The port's flash-attention forward against the JAX package's.

On the CPU the port's wrapper runs its plain version; it is held against
the real Pallas kernel ``_fwd_kernel`` run in interpret mode
(``_flash_fwd(..., interpret=True)``) on the same numpy inputs, out and
lse at fp32 2e-5 (the tolerance of ``tests/unit/test_flash_attention.py``
for the forward: the two sum in different orders).  The Hopper kernel
itself runs only on the card: ``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import flash_attention as jfa
from deepspeed_tpu_torch.ops.transformer.flash_attention import (
    MAX_FLOOR, NEG_INF, flash_attention_fwd, flash_attention_reference)

FWD_TOL = 2e-5


def make_inputs(seed, b, s, kv_len, h, d, masked, masked_rows=()):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, kv_len, h, d).astype(np.float32)
    v = rng.randn(b, kv_len, h, d).astype(np.float32)
    mask = None
    if masked or masked_rows:
        mask = (rng.rand(b, kv_len) > 0.3).astype(np.float32)
        mask[:, 0] = 1.0
        for row in masked_rows:
            mask[row] = 0.0
    return q, k, v, mask


def torch_fwd(q, k, v, mask, causal):
    out, lse = flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask), causal=causal)
    return out.numpy(), lse.numpy()


def pallas_fwd(q, k, v, mask, causal, block):
    out, res = jfa._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), None, causal, block,
        block, True, 0.0)
    b, s, h, _ = q.shape
    return np.asarray(out), np.asarray(res[-1]).reshape(b * h, s)


@pytest.mark.parametrize("s,kv_len", [(128, 128), (256, 256), (128, 256)],
                         ids=["single_tile", "streamed", "kv_len_ne_s"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "kv_mask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_matches_pallas_interpret(s, kv_len, masked, causal):
    q, k, v, mask = make_inputs(s + kv_len + 7 * masked + causal, 2, s,
                                kv_len, 2, 64, masked)
    out_j, lse_j = pallas_fwd(q, k, v, mask, causal, 128)
    out_t, lse_t = torch_fwd(q, k, v, mask, causal)
    np.testing.assert_allclose(out_t, out_j, atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(lse_t, lse_j, atol=FWD_TOL, rtol=FWD_TOL)


def test_fully_masked_row_gives_zero_and_floor_lse():
    q, k, v, mask = make_inputs(3, 2, 128, 128, 2, 64, True, masked_rows=(1,))
    out_j, lse_j = pallas_fwd(q, k, v, mask, False, 128)
    out_t, lse_t = torch_fwd(q, k, v, mask, False)
    np.testing.assert_allclose(out_t, out_j, atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(lse_t, lse_j, atol=FWD_TOL, rtol=FWD_TOL)
    assert np.all(out_t[1] == 0.0)
    assert np.all(lse_t.reshape(2, 2, 128)[1] == np.float32(MAX_FLOOR))
    assert np.all(np.isfinite(out_t[0])) and np.any(out_t[0] != 0.0)


@pytest.mark.parametrize("kv_len", [100, 77])
@pytest.mark.parametrize("causal", [False, True])
def test_ragged_matches_jnp_reference(kv_len, causal):
    """s=100 divides into no 128 block, which the Pallas kernel refuses;
    its dense twin ``_jnp_flash_reference`` states the semantics."""
    q, k, v, mask = make_inputs(kv_len, 2, 100, kv_len, 2, 64, True)
    out_j, lse_j = jfa._jnp_flash_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        causal)
    out_t, lse_t = torch_fwd(q, k, v, mask, causal)
    np.testing.assert_allclose(out_t, np.asarray(out_j), atol=FWD_TOL,
                               rtol=FWD_TOL)
    np.testing.assert_allclose(lse_t, np.asarray(lse_j).reshape(4, 100),
                               atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_dropout_raises_on_any_device(device):
    q = torch.zeros((1, 128, 2, 64), device=device)
    with pytest.raises(NotImplementedError, match="dropout"):
        flash_attention_fwd(q, q, q, dropout_rate=0.1)


def test_neg_inf_and_floor_match_jax():
    assert NEG_INF == jfa.NEG_INF and MAX_FLOOR == jfa.MAX_FLOOR


def test_bf16_plain_rounds_p_before_pv():
    """In bf16 the plain version casts P to bf16 before the P·V product,
    as the TPU kernel does: it matches the fp32 result to bf16 precision
    (atol/rtol 2e-2, the card's bf16 tolerance)."""
    q, k, v, mask = make_inputs(5, 1, 128, 128, 2, 64, True)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out32, lse32 = flash_attention_reference(*t, torch.from_numpy(mask),
                                             causal=True)
    out16, lse16 = flash_attention_reference(
        *[x.bfloat16() for x in t], torch.from_numpy(mask), causal=True)
    assert out16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    torch.testing.assert_close(out16.float(), out32, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse16, lse32, atol=2e-2, rtol=2e-2)
