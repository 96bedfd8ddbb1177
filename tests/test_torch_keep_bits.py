"""B4, the attention-dropout keep mask drawn once per forward into packed
bits, on the CPU.

The JAX package draws its mask inside every Pallas kernel from the TPU's
hardware PRNG, which has no interpret mode; the port's plain version
``philox_keep_bits`` is held here to ``philox_keep_mask`` (whose Philox
is checked against Random123's known answers and against the JAX
package's threshold in ``tests/test_torch_flash_attention.py``), and the
wrappers and ``FlashAttention`` are held, on the same numpy inputs,
bitwise to what they gave when every kernel drew the full mask from the
seed.  The kernel itself runs on the card:
``tests/test_torch_cuda_kernels.py``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import flash_attention as jfa
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def seed_words(a, b):
    return torch.tensor([a, b], dtype=torch.int32)


def inputs(seed, b, s, kv_len, h, d=64):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(b, n, h, d).astype(np.float32))
               for n in (s, kv_len, kv_len))
    mask = (rng.rand(b, kv_len) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    dout = torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
    return q, k, v, torch.from_numpy(mask), dout


def visible_groups(s, kv_len, causal):
    """[s, kv_len] bool: the columns whose group of 4 B4 draws."""
    if not causal:
        return torch.ones(s, kv_len, dtype=torch.bool)
    return (torch.arange(kv_len)[None, :] // 4
            <= torch.arange(s)[:, None] // 4)


@pytest.mark.parametrize("s,kv_len", [(33, 33), (40, 77), (64, 100),
                                      (17, 200)])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_bits_unpack_to_the_keep_mask(s, kv_len, causal):
    """``philox_keep_bits`` holds ``philox_keep_mask``'s mask exactly,
    with 0 in every group of 4 columns a causal row cannot see; the words
    past kv_len are 0."""
    seed = seed_words(7, -3)
    bits = fa.philox_keep_bits(seed, 6, s, kv_len, 0.3, causal=causal)
    assert bits.dtype == torch.int32
    assert tuple(bits.shape) == (6, s, (kv_len + 31) // 32)
    full = fa.philox_keep_mask(seed, 6, s, kv_len, 0.3)
    want = full & visible_groups(s, kv_len, causal)
    assert torch.equal(fa.unpack_keep_bits(bits, kv_len), want)
    padded = fa.unpack_keep_bits(bits, 32 * bits.shape[-1])
    assert not padded[..., kv_len:].any()


def test_plain_bits_of_a_head_range_are_the_whole_calls():
    """A tensor-parallel rank's heads 2..3 of 5 draw exactly the whole
    call's bits of those heads (the counter counts the global head)."""
    seed, b, s, kv_len = seed_words(3, 9), 2, 48, 70
    whole = fa.draw_keep_bits(seed, b, 5, s, kv_len, 0.2, True)
    part = fa.draw_keep_bits(seed, b, 2, s, kv_len, 0.2, True, 2, 5)
    assert torch.equal(part.view(b, 2, s, -1),
                       whole.view(b, 5, s, -1)[:, 2:4])


def test_pack_and_unpack_round_trip():
    rng = np.random.RandomState(0)
    mask = torch.from_numpy(rng.rand(3, 5, 71) > 0.5)
    bits = fa.pack_keep_bits(mask)
    assert torch.equal(fa.unpack_keep_bits(bits, 71), mask)
    # bit 31 of a word is its sign bit: int32 words below 0 unpack right
    full = torch.ones(1, 1, 32, dtype=torch.bool)
    assert int(fa.pack_keep_bits(full)) == -1


def test_threshold_is_the_jax_packages():
    """The kept fraction follows the JAX package's threshold: a column is
    dropped iff its 32 bits are below ``_dropout_thresh``'s."""
    seed = seed_words(123, 456)
    bits = fa.philox_keep_bits(seed, 4, 64, 128, 0.1)
    raw = fa.philox_bits(seed, torch.arange(4), torch.arange(64), 0, 128)
    thresh, _ = jfa._dropout_thresh(0.1)
    assert torch.equal(fa.unpack_keep_bits(bits, 128), raw >= thresh)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_wrappers_with_the_bits_equal_the_seed_alone(causal):
    """B1 gives bitwise the same out and lse given the forward's bits as
    given the seed alone; B2a, B2b, B3 and the backward dispatch take the
    bits as their one dropout input (bits drawn again from the seed are
    the forward's; none under dropout raises); all equal the plain
    versions with the full ``philox_keep_mask`` mask (the mask every
    kernel drew before B4 drew once); a CPU draw launches nothing."""
    rate, seed = 0.2, seed_words(11, 12)
    b, s, kv_len, h = 2, 72, 72, 3
    q, k, v, mask, dout = inputs(5 + causal, b, s, kv_len, h)
    draws = fa.draw_keep_bits.launches
    bits = fa.draw_keep_bits(seed, b, h, s, kv_len, rate, causal)
    out, lse = fa.flash_attention_fwd(q, k, v, mask, causal, rate, seed)
    out_b, lse_b = fa.flash_attention_fwd(q, k, v, mask, causal, rate,
                                          keep_bits=bits)
    assert torch.equal(out, out_b) and torch.equal(lse, lse_b)
    full = fa.philox_keep_mask(seed, b * h, s, kv_len, rate).view(
        b, h, s, kv_len)
    inv_keep = fa.dropout_thresh(rate)[1]
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, mask, causal,
                                                    full, inv_keep)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    args = (q, k, v, out, lse, dout, mask, causal, rate)
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, dout, mask,
                                           causal, full, inv_keep)
    # the keep bits are the backward's one dropout input: drawn again from
    # the seed, they are the forward's; without them it raises
    again = fa.draw_keep_bits(seed, b, h, s, kv_len, rate, causal)
    assert torch.equal(again, bits)
    for bwd in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
                fa.flash_attention_bwd_fused, fa.flash_attention_bwd):
        with pytest.raises(ValueError, match="keep bits"):
            bwd(*args)
    by_seed = (fa.flash_attention_bwd_dq(*args, again),) \
        + fa.flash_attention_bwd_dkv(*args, again)
    for grads in (by_seed,
                  (fa.flash_attention_bwd_dq(*args, keep_bits=bits),)
                  + fa.flash_attention_bwd_dkv(*args, keep_bits=bits),
                  fa.flash_attention_bwd_fused(*args, keep_bits=bits),
                  fa.flash_attention_bwd(*args, keep_bits=bits)):
        for g, r in zip(grads, ref):
            assert torch.equal(g, r)
    assert fa.draw_keep_bits.launches == draws


def test_flash_attention_saves_the_bits_and_no_seed():
    """The autograd function draws the bits once in its forward and saves
    them in place of the seed; its backward uses them (grads bitwise the
    wrappers' on the same bits)."""
    rate, seed = 0.1, seed_words(21, 22)
    b, s, h = 2, 40, 2
    q, k, v, mask, dout = inputs(9, b, s, s, h)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.FlashAttention.apply(*leaves, mask, seed, True, rate)
    saved = out.grad_fn.saved_tensors
    bits = fa.draw_keep_bits(seed, b, h, s, s, rate, True)
    assert any(t is not None and t.dtype == torch.int32
               and torch.equal(t, bits) for t in saved)
    assert not any(t is not None and t.numel() == 2
                   and t.dtype == torch.int32 for t in saved)
    out.backward(dout)
    o, lse = fa.flash_attention_fwd(q, k, v, mask, True, rate,
                                    keep_bits=bits)
    assert torch.equal(out.detach(), o)
    want = fa.flash_attention_bwd(q, k, v, o, lse, dout, mask, True, rate,
                                  keep_bits=bits)
    for leaf, g in zip(leaves, want):
        assert torch.equal(leaf.grad, g)


def test_keep_bits_are_checked():
    q, k, v, mask, _ = inputs(1, 1, 32, 40, 2)
    good = fa.draw_keep_bits(seed_words(1, 2), 1, 2, 32, 40, 0.1)
    with pytest.raises(ValueError, match="keep_bits"):
        fa.flash_attention_fwd(q, k, v, mask, False, 0.1,
                               keep_bits=good[:, :, :1].contiguous())
    with pytest.raises(ValueError, match="keep_bits"):
        fa.flash_attention_fwd(q, k, v, mask, False, 0.1,
                               keep_bits=good.long())
    with pytest.raises(ValueError, match="seed"):
        fa.flash_attention_fwd(q, k, v, mask, False, 0.1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.draw_keep_bits(seed_words(1, 2).to("meta"), 1, 2, 32, 40, 0.1)


# One pass of a word loop in cuobjdump's form: an index multiply, three
# Philox multiplies (one on the uniform datapath) and what reads them
# (logic, compares, packing, the mask applied), then the mask's own
# shift, a reused register, the loop counter, the address, the store and
# the branch.
LOOP_SASS = """
IMAD R25, R7, -0x20, R4 ;
IMAD.SHL.U32 R20, R7, 0x8, RZ ;
IMAD.WIDE.U32 R10, R20, -0x326172a9, RZ ;
LOP3.LUT R8, R6, R11, RZ, 0x3c, !PT ;
IMAD.WIDE.U32 R8, R8, -0x2daee0ad, RZ ;
UIMAD.WIDE.U32 UR4, UR6, -0x326172a9, URZ ;
LOP3.LUT R13, R6, UR5, RZ, 0x3c, !PT ;
LOP3.LUT R9, R9, UR5, R10, 0x96, !PT ;
ISETP.GE.U32.AND P1, PT, R8, UR7, PT ;
ISETP.GE.U32.AND P0, PT, R9, UR7, PT ;
SEL R21, RZ, 0x1, !P0 ;
P2R R21, PR, R21, 0x2 ;
IMAD.SHL.U32 R22, R21, 0x10, RZ ;
LOP3.LUT R12, R22, R21, RZ, 0xfc, !PT ;
@!P6 SHF.L.U32 R20, R20, R25, RZ ;
@!P6 LOP3.LUT R12, R12, R20, RZ, 0x30, !PT ;
IMAD.MOV.U32 R8, RZ, RZ, RZ ;
IADD3 R9, R8, 0x1, RZ ;
VIADD R7, R7, 0x4 ;
LEA R18, P0, R9, UR26, 0x2 ;
ISETP.GE.AND P0, PT, R7, UR29, PT ;
STG.E.128 desc[UR24][R18.64], R12 ;
@!P0 BRA 0x700 ;
"""


def test_b4_bound_counts_the_draws_slice_by_pipe():
    lines = [f"/*{0x700 + 16 * i:04x}*/  {line}"
             for i, line in enumerate(LOOP_SASS.strip().splitlines())]
    body = [(m.group(2) or "", m.group(3), m.group(4))
            for m in map(chip_smoke.SASS_LINE.match, lines)]
    assert len(body) == 23
    counts = chip_smoke.sass_draw_counts(body, 2)
    assert counts["draw_instructions"] == 13 / 2
    assert counts["imad_wide"] == 1 and counts["isetp"] == 1
    assert counts["lop3"] == 5 / 2 and counts["uniform"] == 1 / 2
    assert counts["fma_pipe"] == 3 / 2 and counts["alu_pipe"] == 9 / 2
    assert counts["bound_pipe"] == "ALU pipe"
    assert counts["slots_per_draw"] == 9 / 2
    # the multiplies alone are bound by the FMA pipe
    multiplies = [i for i in body if i[1].startswith("IMAD")]
    counts = chip_smoke.sass_draw_counts(multiplies, 1)
    assert counts["bound_pipe"] == "FMA pipe" and counts["alu_pipe"] == 0
    assert counts["slots_per_draw"] == 2
