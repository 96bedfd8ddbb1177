"""The port's flash attention against the JAX package's.

On the CPU the port's wrappers run their plain versions; they are held
against the real Pallas kernels run in interpret mode on the same numpy
inputs: the forward ``_fwd_kernel`` (``_flash_fwd(..., interpret=True)``)
for out and lse, and the backward through ``jax.vjp`` of
``flash_attention(..., interpret=True)`` — with blocks that stream
(``_bwd_dq_kernel`` + ``_bwd_dkv_kernel``) and with one tile
(``_bwd_fused_kernel``).  Tolerances are those of
``tests/unit/test_flash_attention.py``: forward 2e-5, grads 5e-4, fp32
(the two sum in different orders).  The in-kernel dropout (B4) has no
interpret mode in the JAX package (it needs the TPU's PRNG); its plain
version ``philox_keep_mask`` is checked for the properties the kernels
rely on, and the dropout autograd path against torch autograd through a
dense softmax with the same mask.  The Hopper kernels themselves run
only on the card: ``tests/test_torch_cuda_kernels.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import flash_attention as jfa
from deepspeed_tpu_torch.ops.transformer import flash_attention as tfa
from deepspeed_tpu_torch.ops.transformer.flash_attention import (
    MAX_FLOOR, NEG_INF, FlashAttention, dropout_thresh, flash_attention_fwd,
    flash_attention_reference, philox_bits, philox_keep_mask)

FWD_TOL = 2e-5
GRAD_TOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run on one intra-op thread: torch's CPU exp,
    made by two threads at once as a process's first such call under CPU
    contention, can come out of a reduced-accuracy path up to 1.5e-4 off
    on one thread's half (``tests/test_torch_flash_block_sparse.py``).
    Set here and restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# ----------------------------------------------------------------- backward
def torch_grads(q, k, v, mask, causal, dout, seed=None, rate=0.0):
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = FlashAttention.apply(*t, None if mask is None
                               else torch.from_numpy(mask), seed, causal,
                               rate)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), [x.grad.numpy() for x in t]


def pallas_grads(q, k, v, mask, causal, dout, block):
    jm = None if mask is None else jnp.asarray(mask)

    def f(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, jm, None, causal, block,
                                   block, True, 0.0)

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("s,kv_len", [(128, 128), (256, 256), (128, 256)],
                         ids=["single_tile_B3", "streamed_B2", "kv_len_ne_s"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "kv_mask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_backward_matches_pallas_interpret(s, kv_len, masked, causal):
    """The port's backward (B3 / B2a+B2b plain versions behind
    ``FlashAttention``) against the Pallas backward kernels: 128 blocks
    make s=256 stream through ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``
    and s=128 run ``_bwd_fused_kernel``."""
    q, k, v, mask = make_inputs(3 * s + kv_len + masked + 5 * causal, 2, s,
                                kv_len, 2, 64, masked)
    dout = np.random.RandomState(s + 1).randn(*q.shape).astype(np.float32)
    out_j, grads_j = pallas_grads(q, k, v, mask, causal, dout, 128)
    out_t, grads_t = torch_grads(q, k, v, mask, causal, dout)
    np.testing.assert_allclose(out_t, out_j, atol=FWD_TOL, rtol=FWD_TOL)
    for name, gt, gj in zip("qkv", grads_t, grads_j):
        np.testing.assert_allclose(gt, gj, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("s", [128, 256], ids=["B3", "B2"])
def test_backward_fully_masked_row_and_masked_keys_get_zero_grads(s):
    q, k, v, mask = make_inputs(s + 2, 2, s, s, 2, 64, True,
                                masked_rows=(1,))
    dout = np.random.RandomState(s).randn(*q.shape).astype(np.float32)
    _, grads_j = pallas_grads(q, k, v, mask, False, dout, 128)
    _, grads_t = torch_grads(q, k, v, mask, False, dout)
    for name, gt, gj in zip("qkv", grads_t, grads_j):
        np.testing.assert_allclose(gt, gj, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")
        assert np.all(gt[1] == 0.0), f"d{name} on the masked batch row"
    hidden = mask[0] == 0.0
    assert np.all(grads_t[1][0][hidden] == 0.0)
    assert np.all(grads_t[2][0][hidden] == 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_ragged_matches_jnp_reference(causal):
    """s=100 and kv_len=77 divide into no Pallas block; the dense twin
    ``_jnp_flash_reference`` states the semantics."""
    q, k, v, mask = make_inputs(11, 2, 100, 77, 2, 64, True)
    dout = np.random.RandomState(12).randn(*q.shape).astype(np.float32)
    jm = jnp.asarray(mask)
    _, vjp = jax.vjp(lambda *a: jfa._jnp_flash_reference(*a, jm, causal)[0],
                     *(jnp.asarray(x) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(dout))
    _, grads_t = torch_grads(q, k, v, mask, causal, dout)
    for name, gt, gj in zip("qkv", grads_t, grads_j):
        np.testing.assert_allclose(gt, np.asarray(gj), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"d{name}")


def test_cpu_wrappers_count_no_launch():
    """The launch counters of B1, B2a, B2b, B3 and B4 (its draws and the
    launches that apply its mask) move only where a kernel launched: the
    CPU path, dropout included, runs the plain versions and leaves every
    count as it was."""
    counters = (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                tfa.flash_attention_bwd_dkv, tfa.flash_attention_bwd_fused,
                tfa.in_kernel_dropout, tfa.draw_keep_bits)
    before = [c.launches for c in counters]
    q, k, v, mask = (None if x is None else torch.from_numpy(x)
                     for x in make_inputs(5, 2, 64, 64, 2, 64, True))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = FlashAttention.apply(q, k, v, mask, seed_words(1, 2), True, 0.1)
    out.sum().backward()
    assert [c.launches for c in counters] == before


# ------------------------------------------------------------------ dropout
def seed_words(a, b):
    return torch.tensor([a, b], dtype=torch.int32)


def test_philox_bits_match_the_random123_known_answers():
    """Philox4x32-10 of counter (0x243f6a88, 0x85a308d3, 0x13198a2e,
    0x03707344) and key (0xa4093822, 0x299f31d0) is Random123's
    d16cfe09 94fdcceb 5001e420 24126ea1: the counter is (b·h, row,
    col >> 2, 0), so columns 4g..4g+3 of that (b·h, row) read it."""
    seed = torch.tensor([0xa4093822 - (1 << 32), 0x299f31d0],
                        dtype=torch.int32)
    bits = philox_bits(seed, torch.tensor([0x243f6a88]),
                       torch.tensor([0x85a308d3]), 4 * 0x13198a2e,
                       4 * 0x13198a2e + 4)
    # the fourth counter word is 0 in the kernels, so this vector takes
    # c3 = 0x03707344 through the same rounds only in Random123; check
    # the c3 = 0 form against the known answer for c = 0, key = 0
    zero = philox_bits(seed_words(0, 0), torch.tensor([0]),
                       torch.tensor([0]), 0, 4)
    assert [int(x) for x in zero.reshape(-1)] == [
        0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8]
    assert bits.shape == (1, 1, 4)


def test_keep_mask_is_tiling_independent():
    """A sub-block drawn on its own equals the slice of the full mask: the
    counter names the element, so every kernel's tiling draws the same
    bits."""
    seed = seed_words(5, -7)
    full = philox_bits(seed, torch.arange(4), torch.arange(64), 0, 100)
    sub = philox_bits(seed, torch.tensor([1, 3]), torch.arange(17, 41),
                      33, 91)
    assert torch.equal(sub, full[[1, 3]][:, 17:41, 33:91])
    mask = philox_keep_mask(seed, 4, 64, 100, 0.1)
    assert torch.equal(mask, full >= dropout_thresh(0.1)[0])


def test_keep_mask_follows_the_seed():
    a = philox_keep_mask(seed_words(1, 2), 2, 32, 40, 0.3)
    b = philox_keep_mask(seed_words(1, 2), 2, 32, 40, 0.3)
    c = philox_keep_mask(seed_words(1, 3), 2, 32, 40, 0.3)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_dropout_thresh_matches_jax():
    for rate in (1e-12, 0.1, 0.3, 0.5, 1 - 1e-12):
        assert dropout_thresh(rate) == jfa._dropout_thresh(rate)


def test_keep_rate_is_binomial_and_unbiased():
    """Over 262,144 draws the keep rate lies within 5 sigma of
    1 - thresh/2**32, and keep * inv_keep averages 1 within 5 sigma."""
    rate = 0.1
    mask = philox_keep_mask(seed_words(123, 456), 8, 256, 128, rate)
    thresh, inv_keep = dropout_thresh(rate)
    p = 1.0 - thresh / 2.0 ** 32
    n = mask.numel()
    sigma = math.sqrt(p * (1 - p) / n)
    assert abs(float(mask.double().mean()) - p) < 5 * sigma
    assert abs(float((mask.double() * inv_keep).mean()) - 1.0) \
        < 5 * sigma * inv_keep


def test_zero_rate_is_the_no_dropout_program():
    q, k, v, mask = make_inputs(21, 2, 128, 128, 2, 64, True)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    base = FlashAttention.apply(*t, torch.from_numpy(mask), None, True, 0.0)
    seeded = FlashAttention.apply(*t, torch.from_numpy(mask),
                                  seed_words(5, 6), True, 0.0)
    assert torch.equal(base, seeded)


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)])
def test_dropout_grads_match_dense_autograd_with_the_same_mask(causal,
                                                               masked):
    """Forward and grads of the dropout autograd path equal torch autograd
    through a dense softmax with the ``philox_keep_mask`` mask applied
    (fwd 2e-5, grads 5e-4)."""
    rate, seed = 0.2, seed_words(9, 10)
    b, s, h, d = 2, 96, 2, 64
    q, k, v, mask = make_inputs(31 + causal, b, s, s, h, d, masked)
    dout = np.random.RandomState(32).randn(b, s, h, d).astype(np.float32)
    out_t, grads_t = torch_grads(q, k, v, mask, causal, dout, seed, rate)

    keep = philox_keep_mask(seed, b * h, s, s, rate).view(b, h, s, s)
    inv_keep = dropout_thresh(rate)[1]
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    sc = torch.einsum("bqhd,bkhd->bhqk", t[0], t[1]) / math.sqrt(d)
    if causal:
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                            NEG_INF)
    if masked:
        sc = sc.masked_fill(torch.from_numpy(mask)[:, None, None, :] == 0,
                            NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd",
                       torch.where(keep, p * inv_keep, 0.0), t[2])
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out_t, out.detach().numpy(), atol=FWD_TOL,
                               rtol=FWD_TOL)
    for name, gt, x in zip("qkv", grads_t, t):
        np.testing.assert_allclose(gt, x.grad.numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"d{name}")


def test_cuda_wrappers_refuse_other_devices_and_bad_seeds():
    q = torch.zeros((1, 128, 2, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention_bwd(q, q, q, q, torch.zeros((2, 128),
                                                        device="meta"), q)
    c = torch.zeros((1, 128, 2, 64))
    with pytest.raises(ValueError, match="seed"):
        flash_attention_fwd(c, c, c, dropout_rate=0.1)
    with pytest.raises(ValueError, match="seed"):
        flash_attention_fwd(c, c, c, dropout_rate=0.1,
                            seed=torch.zeros(2, dtype=torch.int64))


# ------------------------------------------------- backward dispatch (pure)
def test_mma_aligned_takes_the_main_path_views():
    """The bf16 B2a/B2b read q, k, v and dO by 16-byte cp.async: slices of
    a fused [b, s, 3, h, d] projection, the gathered ``positions`` queries
    with the [b, s, 2, h, d] key/value projection, and a contiguous dO
    all qualify at head_dim 64 and 128."""
    for d in tfa.HEAD_DIMS:
        qkv = torch.zeros(2, 130, 3, 4, d, dtype=torch.bfloat16)
        kv = torch.zeros(2, 128, 2, 4, d, dtype=torch.bfloat16)
        gathered = torch.zeros(2, 21, 4 * d, dtype=torch.bfloat16) \
            .reshape(2, 21, 4, d)
        dout = torch.zeros(2, 130, 4, d, dtype=torch.bfloat16)
        assert tfa.mma_aligned(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dout)
        assert tfa.mma_aligned(gathered, kv[:, :, 0], kv[:, :, 1])


def test_mma_aligned_refuses_what_cp_async_cannot_copy():
    """A base pointer off 16 bytes, or a batch, seq or head stride that is
    not a multiple of 8 elements, is refused; a stride of a dim of
    length 1 does not count."""
    base = torch.zeros(2 * 64 * 4 * 64 + 8, dtype=torch.bfloat16)
    assert tfa.mma_aligned(base[8:].view(2, 64, 4, 64))
    assert not tfa.mma_aligned(base[4:4 + 2 * 64 * 4 * 64].view(2, 64, 4, 64))
    padded = torch.zeros(2, 64, 4, 68, dtype=torch.bfloat16)
    assert not tfa.mma_aligned(padded[..., :64])            # head stride 68
    rows = torch.zeros(2, 64 * 4 * 64 + 4, dtype=torch.bfloat16)
    assert not tfa.mma_aligned(rows[:, :64 * 4 * 64].view(2, 64, 4, 64))
    one = torch.zeros(1, 64, 4, 64, dtype=torch.bfloat16)
    assert tfa.mma_aligned(one.as_strided(one.shape, (3, 256, 64, 1)))


@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
def test_forward_view_rule_takes_main_path_views_and_refuses_the_rest(d):
    """The forward wrapper's rule (``check_fwd_views``), with no card:
    bf16 B1 takes the training and prefill fused-QKV slices, BERT's
    gathered ``positions`` queries with its key/value slices and
    contiguous tensors; it refuses, naming B1, a base off 16 bytes and
    a head or seq stride that is not a multiple of 8 elements.  fp32
    (the scalar B1) takes every view whose last dim is contiguous."""
    qkv = torch.zeros(2, 130, 3, 4, d, dtype=torch.bfloat16)
    kv = torch.zeros(2, 128, 2, 4, d, dtype=torch.bfloat16)
    gathered = torch.zeros(2, 21, 4 * d, dtype=torch.bfloat16) \
        .reshape(2, 21, 4, d)
    contiguous = torch.zeros(2, 130, 4, d, dtype=torch.bfloat16)
    tfa.check_fwd_views(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    tfa.check_fwd_views(gathered, kv[:, :, 0], kv[:, :, 1])
    tfa.check_fwd_views(contiguous, contiguous, contiguous)
    base = torch.zeros(2 * 130 * 4 * d + 4, dtype=torch.bfloat16)
    shifted = base[4:].view(2, 130, 4, d)              # 8 bytes off
    wide = torch.zeros(2, 130, 4, d + 4, dtype=torch.bfloat16)[..., :d]
    rows = torch.zeros(2, 130, 4 * d + 4, dtype=torch.bfloat16)[
        ..., :4 * d].unflatten(-1, (4, d))             # seq stride 4d + 4
    for bad in (shifted, wide, rows):
        for args in ((bad, contiguous, contiguous),
                     (contiguous, bad, contiguous),
                     (contiguous, contiguous, bad)):
            with pytest.raises(ValueError, match="bf16 B1"):
                tfa.check_fwd_views(*args)
    odd = torch.zeros(2 * 130 * 4 * d + 1)[1:].view(2, 130, 4, d)
    tfa.check_fwd_views(odd, torch.zeros(2, 130, 4, d + 4)[..., :d], odd)


def fused_smem(d, s, kv_len, dtype):
    """B3's shared memory for one b·h, mirrored from the CUDA source:
    ``fused_smem_floats`` (fp32) and ``fused_mma_smem_bytes`` (bf16)."""
    if dtype == torch.float32:
        words = (kv_len + 31) // 32
        return 4 * (2 * s * d + 2 * kv_len * (d + 1) + s * kv_len + 2 * s
                    + kv_len + s * words)
    rows, keys = (s + 15) // 16 * 16, (kv_len + 31) // 32 * 32
    return (2 * (2 * (rows + keys) * (d + 8) + 2 * rows * (keys + 8))
            + 4 * keys + 4 * rows * (keys // 32))


@pytest.mark.parametrize("rows", [0, 21, 128, None])
def test_use_fused_backward_rule(monkeypatch, rows):
    """With B3's shared-memory sizes stubbed by both formulas of the CUDA
    source: the fp32 tiles fit up to s = kv_len = 142 at d=64 and 94 at
    d=128, the bf16 ones up to 160 and 128 (the 21 gathered rows against
    up to 512 keys at d=64); fp32 takes B3 wherever it fits, bf16 up to
    ``BF16_FUSED_MAX_LEN`` query rows and keys (set to ``rows`` here, or
    the module's own measured constant for ``None``), and neither where
    it does not fit."""
    monkeypatch.setattr(tfa, "fused_smem_bytes", fused_smem)
    if rows is not None:
        monkeypatch.setattr(tfa, "BF16_FUSED_MAX_LEN", rows)
    f32, b16 = torch.float32, torch.bfloat16
    assert tfa.fused_backward_fits(64, 142, 142, f32)
    assert not tfa.fused_backward_fits(64, 143, 143, f32)
    assert tfa.fused_backward_fits(128, 94, 94, f32)
    assert not tfa.fused_backward_fits(128, 95, 95, f32)
    for s, kv_len in ((128, 128), (21, 128), (160, 160), (21, 512)):
        assert tfa.fused_backward_fits(64, s, kv_len, b16)
    for s, kv_len in ((161, 161), (21, 513)):
        assert not tfa.fused_backward_fits(64, s, kv_len, b16)
    assert tfa.fused_backward_fits(128, 128, 128, b16)
    assert not tfa.fused_backward_fits(128, 129, 129, b16)
    for s, kv_len in ((21, 128), (128, 128), (142, 142), (160, 160),
                      (21, 512)):
        assert tfa.use_fused_backward(64, s, kv_len, f32) == (
            tfa.fused_backward_fits(64, s, kv_len, f32))
        assert tfa.use_fused_backward(64, s, kv_len, b16) == (
            max(s, kv_len) <= tfa.BF16_FUSED_MAX_LEN)
    for dtype in (f32, b16):
        assert not tfa.use_fused_backward(64, 161, 161, dtype)
        assert not tfa.use_fused_backward(128, 129, 129, dtype)


@pytest.mark.parametrize("s", [128, 21], ids=["s128", "gathered_s21"])
def test_bf16_plain_backward_matches_pallas_fused_interpret(s):
    """The bf16 plain backward, which the card holds the tensor-core B3
    to, against the Pallas ``_bwd_fused_kernel`` in interpret mode (one
    tile: block_q = s, block_k = 128) on the same bf16 inputs with a key
    mask holding padding, fed the Pallas forward's out and lse; at BERT's
    s=128 and its last layer's 21 gathered rows against 128 keys.  No
    dropout: the TPU's PRNG has no interpret mode.  Tolerance 1e-2, the
    card's bf16 grad tolerance: both round dS and P_kept to bf16 after
    fp32 sums that can differ in the last bits."""
    q, k, v, mask = make_inputs(s + 31, 2, s, 128, 2, 64, True)
    dout = np.random.RandomState(s).randn(*q.shape).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, dout))
    jm = jnp.asarray(mask)
    out_j, res = jfa._flash_fwd(jq, jk, jv, jm, None, False, s, 128, True,
                                0.0)
    grads_j = jfa._flash_bwd_rule(False, s, 128, True, 0.0, res, jdo)[:3]
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
         for x in (jq, jk, jv, out_j, jdo)]
    lse = torch.from_numpy(np.array(res[-1])).reshape(4, s)
    grads_t = tfa.flash_attention_bwd_reference(*t[:4], lse, t[4],
                                                torch.from_numpy(mask))
    for name, gt, gj in zip("qkv", grads_t, grads_j):
        assert gt.dtype == torch.bfloat16
        np.testing.assert_allclose(gt.float().numpy(),
                                   np.asarray(gj.astype(jnp.float32)),
                                   atol=1e-2, rtol=1e-2, err_msg=f"d{name}")


def test_backward_wrappers_take_a_shared_delta():
    """``flash_attention_bwd_dq`` / ``_dkv`` accept the Δ that
    ``flash_attention_bwd`` computes once; on the CPU the plain version
    gives the same grads with and without it, and Δ is rowsum(dO∘O)."""
    q, k, v, mask = (None if x is None else torch.from_numpy(x)
                     for x in make_inputs(3, 2, 70, 90, 2, 64, True))
    dout = torch.from_numpy(
        np.random.RandomState(4).randn(2, 70, 2, 64).astype(np.float32))
    out, lse = flash_attention_fwd(q, k, v, mask)
    delta = tfa._delta(out, dout)
    assert delta.shape == (4, 70) and delta.is_contiguous()
    torch.testing.assert_close(
        delta, (dout * out).sum(-1).transpose(1, 2).reshape(4, 70))
    args = (q, k, v, out, lse, dout, mask, False)
    torch.testing.assert_close(tfa.flash_attention_bwd_dq(*args, delta=delta),
                               tfa.flash_attention_bwd_dq(*args))
    for a, b in zip(tfa.flash_attention_bwd_dkv(*args, delta=delta),
                    tfa.flash_attention_bwd(*args)[1:]):
        torch.testing.assert_close(a, b)
