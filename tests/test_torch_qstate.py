"""Reduced-precision host state (``runtime/zero/qstate.py``) against the
JAX package's ``qstate``.

- ``ef_store`` (nearest value and residual) is bitwise JAX's, in bf16
  and fp16;
- the stochastic-rounding bit trick, fed the bits the JAX function
  draws from its key, is bitwise JAX's (the port draws its own bits from
  a ``torch.Generator``, so the draws themselves agree in distribution
  only);
- SR is unbiased and neighbour-valued and passes non-finite values
  through (the JAX test at ``test_offload_state_dtype.py:284``), the
  error-feedback round trip is below 2^-14 (``:312``);
- ``host_state_bytes_per_step`` equals JAX's for the fp32, SR and EF
  layouts, and the SR seed depends on the step, the tag and the slot
  only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam.fused_adam import FusedAdam as JFusedAdam
from deepspeed_tpu.runtime.zero import qstate as jq
from deepspeed_tpu_torch.runtime.zero import qstate as tq

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16, torch.int16),
          "fp16": (torch.float16, jnp.float16, torch.int16)}


def words(t):
    """The 16-bit patterns of a bf16/fp16 torch tensor."""
    return t.view(torch.int16).numpy().view(np.uint16)


def jwords(a):
    return np.asarray(a).view(np.uint16)


def sample(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n,)).astype(np.float32)
    x[:8] = [1e-30, -1e-30, 6e4, -7e4, 3e38, 1.0, -0.0, 2.0 ** -20]
    return x


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_ef_store_is_bitwise_jax(name):
    tdt, jdt, _ = DTYPES[name]
    x = sample(4096, 0)
    jqv, jr = jq.ef_store(jnp.asarray(x), jdt)
    q, r = tq.ef_store(torch.from_numpy(x), tdt)
    assert q.dtype == r.dtype == tdt
    np.testing.assert_array_equal(words(q), jwords(jqv))
    np.testing.assert_array_equal(words(r), jwords(jr))


@pytest.mark.parametrize("name,span", [("bf16", 0xFFFF), ("fp16", 0x1FFF)])
def test_stochastic_rounding_bits_are_bitwise_jax(name, span):
    """Given the JAX function's own random bits, the port's int32 form
    of the bit trick gives the same words, non-finite values too."""
    tdt, jdt, _ = DTYPES[name]
    x = sample(8192, 1)
    x[8:12] = [np.inf, -np.inf, np.nan, 3.3e38]
    key = jax.random.PRNGKey(3)
    bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint32)) & span
    want = jq.stochastic_round(jnp.asarray(x), jdt, key)
    got = tq.sr_from_bits(torch.from_numpy(x), tdt,
                          torch.from_numpy(bits.astype(np.int32)))
    # a NaN's payload is the conversion's (torch's CPU bf16 cast gives
    # 0xFFFF, XLA's 0x7FC0): NaN where JAX has NaN, every other word equal
    nan = np.isnan(np.asarray(want, np.float32))
    assert np.array_equal(nan, torch.isnan(got.float()).numpy())
    np.testing.assert_array_equal(words(got)[~nan], jwords(want)[~nan])


def test_stochastic_round_unbiased_and_neighbour_valued():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4096,)).astype(np.float32) * 0.37)
    lo = x.to(torch.bfloat16).float()
    draws = []
    for i in range(64):
        q = tq.stochastic_round(x, torch.bfloat16,
                                torch.Generator().manual_seed(i)).float()
        ulp = lo.abs() * 2.0 ** -7 + 1e-45
        assert bool(((q - x).abs() <= ulp).all())
        draws.append(q)
    mean = torch.stack(draws).mean(0)
    # unbiased: the mean of 64 draws beats nearest's fixed error
    assert (mean - x).abs().mean() < (lo - x).abs().mean()
    special = torch.tensor([np.inf, -np.inf, np.nan, 0.0, -0.0])
    qs = tq.stochastic_round(special, torch.bfloat16,
                             torch.Generator().manual_seed(0)).float()
    assert qs[0] == np.inf and qs[1] == -np.inf and torch.isnan(qs[2])
    assert qs[3] == 0.0 and qs[4] == 0.0


def test_ef_roundtrip_precision():
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1024,)).astype(np.float32))
    q, r = tq.ef_store(x, torch.bfloat16)
    recon = q.float() + r.float()
    rel = (recon - x).abs() / x.abs().clamp_min(1e-30)
    assert float(rel.max()) < 2.0 ** -14


LAYOUTS = {"fp32": None, "sr": "bf16",
           "ef": {"master": "bf16", "momentum": "bf16", "variance": "bf16",
                  "error_feedback": True},
           "mixed": {"momentum": "fp16", "variance": "bf16"}}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_host_state_bytes_per_step_equals_jax(layout):
    from deepspeed_tpu.runtime.zero.config import DeepSpeedZeroConfig as JZ

    from deepspeed_tpu_torch.runtime.zero.config import \
        DeepSpeedZeroConfig as TZ

    zo = {"stage": 2, "cpu_offload": True}
    if LAYOUTS[layout] is not None:
        zo["offload_state_dtype"] = LAYOUTS[layout]
    jsd = JZ({"zero_optimization": zo}).offload_state_dtype
    tsd = TZ({"zero_optimization": zo}).offload_state_dtype
    assert jsd == tsd
    rows, lanes = 37, 1024
    shape = jax.eval_shape(JFusedAdam().init_state,
                           jax.ShapeDtypeStruct((rows, lanes), jnp.float32))
    jquant = jq.build_state_quant(jsd, shape)
    tquant = tq.build_state_quant(tsd, [("exp_avg", True),
                                        ("exp_avg_sq", True),
                                        ("step", False)])
    assert (jquant is None) == (tquant is None)
    want = jq.host_state_bytes_per_step(rows, lanes, jquant)
    assert tq.host_state_bytes_per_step(rows, lanes, tquant) == want
    if tquant is not None:
        assert tquant.residual_names() == jquant.residual_names()
        assert [n for n in ("master", "exp_avg", "exp_avg_sq")
                if tquant.dtype_of(n) != torch.float32] \
            == jquant.reduced_names
    if layout == "sr":
        assert 2 * want == jq.host_state_bytes_per_step(rows, lanes, None)


def test_sr_seed_depends_on_step_tag_and_slot():
    quant = tq.build_state_quant({"master": "bf16"}, [("exp_avg", True),
                                                      ("step", False)])
    keys = {quant.chunk_key(step, tag, slot) for step in (1, 2)
            for tag in (0, 1, 2) for slot in (0, 1)}
    assert len(keys) == 12
    assert quant.chunk_key(5, 3, 1) == quant.chunk_key(5, 3, 1)
    x = torch.randn(1000)
    a, _ = quant.store(x, torch.bfloat16, step=5, tag=3, slot=1)
    b, _ = quant.store(x, torch.bfloat16, step=5, tag=3, slot=1)
    c, _ = quant.store(x, torch.bfloat16, step=6, tag=3, slot=1)
    assert torch.equal(a, b) and not torch.equal(a, c)
