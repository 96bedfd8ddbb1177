"""The port's Hopper kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX, so it runs on a machine with PyTorch alone, without
the repo's conftest (which loads JAX):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda

Tolerances: the forward fp32 2e-5 (matmuls in full fp32, TF32 off; only
the summation order differs), bf16 2e-2 (both round P to bf16 before P·V
and the output to bf16, at different points of a different summation
order); the backward fp32 5e-4 (the flash tests' grad tolerance), bf16
1e-2 (dS and P rounded to bf16 after fp32 sums in another order).  fp16
is held to bf16's bounds: it rounds at the same points, with three more
bits.  The
block-sparse kernels B5a and B5b and the super-tile kernels B6a, B6b and
B6c are held to the same four bounds.
"""

import ctypes
import warnings

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.ops.sparse_attention import \
    flash_block_sparse as fbs
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    BigBirdSparsityConfig, FixedSparsityConfig)
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.ops.transformer.flash_attention import (
    flash_attention_bwd_dkv, flash_attention_bwd_dq,
    flash_attention_bwd_fused, flash_attention_bwd_reference,
    flash_attention_fwd, flash_attention_reference, philox_keep_mask)

GRAD_TOLS = {torch.float32: 5e-4, torch.bfloat16: 1e-2,
             torch.float16: 1e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python -m pytest "
                    "--noconftest tests/test_torch_cuda_kernels.py -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def make_inputs(seed, b, s, kv_len, h, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, kv_len, h, d).astype(np.float32)
    v = rng.randn(b, kv_len, h, d).astype(np.float32)
    mask = (rng.rand(b, kv_len) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[-1] = 0.0   # the last batch row sees no key at all
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("b,s,kv_len,d,causal,rate,fused", [
    (2, 128, 128, 64, True, 0.0, False), (2, 300, 300, 64, True, 0.0, False),
    (2, 256, 200, 64, False, 0.0, False), (2, 200, 320, 64, True, 0.0, False),
    (2, 128, 128, 128, True, 0.0, False),
    # edges of the bf16 kernel's 64-row tiles
    (2, 65, 65, 64, True, 0.0, False),        # one row past a tile
    (2, 100, 201, 64, False, 0.1, False),     # kv_len 201 under dropout
    (2, 128, 256, 64, True, 0.0, False),      # causal, kv_len > s
    (2, 1024, 1024, 128, True, 0.0, True),    # d=128 on fused-QKV views
    (2, 1024, 1024, 64, False, 0.0, False),   # a fully masked row at 1024
    (8, 21, 128, 64, False, 0.1, False)])     # BERT's 21 gathered rows
def test_flash_fwd_kernel_matches_plain(cuda_device, dtype, tol, b, s,
                                        kv_len, d, causal, rate, fused):
    """B1 against its plain version with the same Philox mask; bf16 lse
    also to 1e-4 (both take fp32 scores of the same bf16 operands); the
    last batch row sees no key: out exactly 0 and lse MAX_FLOOR."""
    q, k, v, mask = make_inputs(s + d, b, s, kv_len, 4, d)
    if fused:
        qkv = torch.from_numpy(np.stack((q, k, v), 2)).to(cuda_device, dtype)
        t = [qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]]
    else:
        t = [torch.from_numpy(x).to(cuda_device, dtype) for x in (q, k, v)]
    m = torch.from_numpy(mask).to(cuda_device)
    seed = torch.tensor([s, d], dtype=torch.int32, device=cuda_device) \
        if rate else None
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(*t, m, causal, rate, seed)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    keep, inv_keep = None, 1.0
    if rate:
        keep = philox_keep_mask(seed, b * 4, s, kv_len, rate).view(
            b, 4, s, kv_len)
        inv_keep = fa.dropout_thresh(rate)[1]
    ref_out, ref_lse = flash_attention_reference(*t, m, causal, keep,
                                                 inv_keep)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)
    if dtype != torch.float32:
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    assert bool((out[-1] == 0).all())
    assert bool((lse.view(b, 4, s)[-1] == fa.MAX_FLOOR).all())


@pytest.mark.cuda
def test_flash_fwd_kernel_reads_strided_qkv_views(cuda_device):
    """q, k, v sliced from one fused [b, s, 3, h, d] projection go in as
    strided views, with no copy, and give the contiguous inputs' answer."""
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(1, 192, 3, 4, 64, generator=g).to(cuda_device,
                                                         torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    ref_out, ref_lse = flash_attention_fwd(q.contiguous(), k.contiguous(),
                                           v.contiguous(), causal=True)
    torch.testing.assert_close(out, ref_out, atol=0, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("telemetry", [False, True],
                         ids=["telemetry_off", "telemetry_on"])
def test_engine_syncs_once_per_prefill_and_decode_iteration(
        cuda_device, telemetry, tmp_path):
    """The serve loop's only host syncs are its token fetches: one per
    prefill and one per decode iteration (counted by CUDA sync debug
    mode, which warns at every synchronizing call), with the telemetry
    and observability plane on too (events, an SLO, the cadence every
    iteration)."""
    config = GPT2Config(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, max_position_embeddings=256)
    serve = {"inference": {
        "kv_block_size": 16, "max_seq_len": 256,
        "prefill_buckets": [128, 256], "max_batch_slots": 4,
        "kv_blocks": 64, "token_budget": 1024, "max_new_tokens": 4}}
    if telemetry:
        serve["inference"]["slo"] = {"ttft_ms": 1000, "per_token_ms": 50}
        serve["steps_per_print"] = 1
        serve["telemetry"] = {"enabled": True, "run_dir": str(tmp_path),
                              "trace": True}
    engine = InferenceEngine(
        GPT2LMHead(config), random_params(config, seed=0), config=serve,
        device=cuda_device)
    rng = np.random.RandomState(0)
    engine.submit(rng.randint(0, 512, size=100).tolist())
    engine.run()   # warm-up: builds the kernel, cuBLAS handles, allocator
    engine.submit(rng.randint(0, 512, size=150).tolist())
    engine.submit(rng.randint(0, 512, size=60).tolist())
    torch.cuda.synchronize()
    counts = []
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for _ in range(3):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                engine.step()
            counts.append(sum("synchroniz" in str(w.message)
                              for w in caught))
    finally:
        torch.cuda.set_sync_debug_mode(previous)
    # step 1: two prefills and a decode; steps 2 and 3: a decode each
    assert counts == [3, 1, 1]
    assert engine.decode_iterations == 3 + 3
    engine.close()


def keep_bits_of(seed, q, k, causal, rate, head_offset=0, total_heads=None):
    """B4's bits of a call (None without dropout): the backward wrappers'
    one dropout input."""
    if not rate:
        return None
    b, s, h, _ = q.shape
    return fa.draw_keep_bits(seed, b, h, s, k.shape[1], rate, causal,
                             head_offset, total_heads)


def backward_by_kernels(path, q, k, v, out, lse, dout, mask, causal, rate,
                        seed):
    bits = keep_bits_of(seed, q, k, causal, rate)
    if path == "b3":
        return flash_attention_bwd_fused(q, k, v, out, lse, dout, mask,
                                         causal, rate, bits)
    dq = flash_attention_bwd_dq(q, k, v, out, lse, dout, mask, causal, rate,
                                bits)
    return (dq,) + flash_attention_bwd_dkv(q, k, v, out, lse, dout, mask,
                                           causal, rate, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("path,s,kv_len,d,causal,rate", [
    ("b2", 256, 256, 64, True, 0.0), ("b2", 300, 200, 64, False, 0.0),
    ("b2", 128, 128, 128, True, 0.0), ("b2", 256, 256, 64, True, 0.1),
    ("b3", 128, 128, 64, True, 0.0), ("b3", 64, 64, 128, False, 0.1),
    # edges of the bf16 kernels' 64-row tiles: one row past a tile,
    # kv_len not a multiple of 4 under dropout, causal with kv_len > s,
    # head_dim 128 with dropout over ragged tiles
    ("b2", 65, 65, 64, True, 0.0), ("b2", 100, 201, 64, False, 0.1),
    ("b2", 128, 256, 64, True, 0.0), ("b2", 200, 200, 128, False, 0.1)])
def test_backward_kernels_match_plain(cuda_device, dtype, path, s, kv_len, d,
                                      causal, rate):
    """B2a+B2b or B3, with B4 under dropout, against
    ``flash_attention_bwd_reference`` fed the kernel's own out and lse;
    the masked batch row gets exactly zero grads, and a second run is
    bitwise equal."""
    q, k, v, mask = make_inputs(s + kv_len + d, 2, s, kv_len, 4, d)
    t = [torch.from_numpy(x).to(cuda_device, dtype) for x in (q, k, v)]
    m = torch.from_numpy(mask).to(cuda_device)
    dout = torch.randn(2, s, 4, d, generator=torch.Generator()
                       .manual_seed(s)).to(cuda_device, dtype)
    seed = (torch.tensor([s, d], dtype=torch.int32, device=cuda_device)
            if rate else None)
    out, lse = flash_attention_fwd(*t, m, causal, rate, seed)
    counters = (flash_attention_bwd_dq, flash_attention_bwd_dkv,
                flash_attention_bwd_fused, fa.in_kernel_dropout)
    before = [c.launches for c in counters]
    grads = backward_by_kernels(path, *t, out, lse, dout, m, causal, rate,
                                seed)
    again = backward_by_kernels(path, *t, out, lse, dout, m, causal, rate,
                                seed)
    torch.cuda.synchronize()
    bwd_launches = [0, 0, 2] if path == "b3" else [2, 2, 0]
    assert [c.launches - b for c, b in zip(counters, before)] == (
        bwd_launches + [sum(bwd_launches) if rate else 0])
    keep, inv_keep = None, 1.0
    if rate:
        keep = philox_keep_mask(seed, 8, s, kv_len, rate).view(2, 4, s,
                                                                 kv_len)
        inv_keep = fa.dropout_thresh(rate)[1]
    ref = flash_attention_bwd_reference(*t, out, lse, dout, m, causal, keep,
                                        inv_keep)
    tol = GRAD_TOLS[dtype]
    for g, g2, r in zip(grads, again, ref):
        assert torch.equal(g, g2)
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol)
        assert bool((g[-1] == 0).all())


@pytest.mark.cuda
def test_fused_backward_fits(cuda_device):
    """B3 fits where its tiles fit one block's 232,448 bytes of shared
    memory, as the CUDA source counts them per dtype: fp32 (Q, dO, K, V
    and the score tile in fp32) s = kv_len <= 142 at d=64, <= 94 at
    d=128; bf16 (Q, dO, K, V, P_kept and dS in bf16) <= 160 at d=64,
    <= 128 at d=128, and BERT's 21 gathered rows against up to 512 keys
    at d=64."""
    f32, b16 = torch.float32, torch.bfloat16
    assert fa.fused_backward_fits(64, 128, 128, f32)
    assert fa.fused_backward_fits(64, 142, 142, f32)
    assert not fa.fused_backward_fits(64, 143, 143, f32)
    assert not fa.fused_backward_fits(64, 256, 256, f32)
    assert fa.fused_backward_fits(128, 94, 94, f32)
    assert not fa.fused_backward_fits(128, 95, 95, f32)
    assert fa.fused_backward_fits(64, 128, 128, b16)
    assert fa.fused_backward_fits(64, 21, 128, b16)
    assert fa.fused_backward_fits(64, 160, 160, b16)
    assert not fa.fused_backward_fits(64, 161, 161, b16)
    assert fa.fused_backward_fits(128, 128, 128, b16)
    assert not fa.fused_backward_fits(128, 129, 129, b16)
    assert fa.fused_backward_fits(64, 21, 512, b16)
    assert not fa.fused_backward_fits(64, 21, 513, b16)


@pytest.mark.cuda
def test_fused_backward_choice_follows_dtype(cuda_device):
    """fp32 takes B3 wherever it fits; bf16 up to
    ``BF16_FUSED_MAX_LEN`` query rows and keys, where it measured faster
    than B2a+B2b (BERT's 128 x 128 and 21 x 128 among them), and neither
    where B3 does not fit."""
    for s, kv_len in ((128, 128), (21, 128), (142, 142)):
        assert fa.use_fused_backward(64, s, kv_len, torch.float32)
    for s, kv_len in ((128, 128), (21, 128), (160, 160), (64, 64)):
        assert fa.use_fused_backward(64, s, kv_len, torch.bfloat16)
    assert not fa.use_fused_backward(64, 21, 512, torch.bfloat16)
    for dtype in (torch.float32, torch.bfloat16):
        assert not fa.use_fused_backward(64, 161, 161, dtype)
        assert not fa.use_fused_backward(128, 129, 129, dtype)


def b3_cases():
    """name -> (b, h, s, kv_len, d, causal, dropout, mask kind, fused QKV
    views): the bf16 B3 at BERT's three main-path shapes (b=64 and b=8 at
    s=128, the last layer's 21 gathered rows at b=64) with a key mask and
    dropout 0.1, and at the edges of its 16-row and 32-key tiles."""
    return {
        "bert_b64_s128": (64, 16, 128, 128, 64, False, 0.1, "ones", False),
        "bert_b64_gathered_s21": (64, 16, 21, 128, 64, False, 0.1, "ones",
                                  False),
        "bert_b8_s128": (8, 16, 128, 128, 64, False, 0.1, "ones", False),
        "causal_fused_views": (2, 4, 128, 128, 64, True, 0.0, "none", True),
        "padded_and_fully_masked_row": (2, 4, 128, 128, 64, False, 0.1,
                                        "pad", False),
        "s65": (2, 4, 65, 65, 64, True, 0.1, "pad", False),
        "s17": (2, 4, 17, 17, 64, False, 0.0, "pad", False),
        "d128_fused_views": (2, 4, 128, 128, 128, False, 0.1, "none", True),
        "kv_gt_s_causal": (2, 4, 33, 200, 64, True, 0.1, "pad", False),
    }


def check_b3_case(cuda_device, name, dtype):
    """B3 on the tensor cores at ``b3_cases()[name]`` in ``dtype``
    against the plain version (see the two tests below)."""
    b, h, s, kv_len, d, causal, rate, mask_kind, fused = b3_cases()[name]
    g = torch.Generator().manual_seed(len(name))
    if fused:
        qkv = torch.randn(b, s, 3, h, d, generator=g).to(cuda_device, dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = torch.randn(b, s, h, d, generator=g).to(cuda_device, dtype)
        k, v = (torch.randn(b, kv_len, h, d, generator=g)
                .to(cuda_device, dtype) for _ in range(2))
    dout = torch.randn(b, s, h, d, generator=g).to(cuda_device, dtype)
    mask = None
    if mask_kind == "ones":
        mask = torch.ones(b, kv_len, device=cuda_device)
    elif mask_kind == "pad":
        mask = (torch.rand(b, kv_len, generator=g) > 0.3).float()
        mask[:, 0] = 1.0
        mask[-1] = 0.0          # the last batch row sees no key at all
        mask = mask.to(cuda_device)
    seed = (torch.tensor([s, kv_len], dtype=torch.int32, device=cuda_device)
            if rate else None)
    out, lse = flash_attention_fwd(q, k, v, mask, causal, rate, seed)
    counters = (flash_attention_bwd_dq, flash_attention_bwd_dkv,
                flash_attention_bwd_fused, fa.in_kernel_dropout)
    bits = keep_bits_of(seed, q, k, causal, rate)
    before = [c.launches for c in counters]
    grads = flash_attention_bwd_fused(q, k, v, out, lse, dout, mask, causal,
                                      rate, bits)
    again = flash_attention_bwd_fused(q, k, v, out, lse, dout, mask, causal,
                                      rate, bits)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [
        0, 0, 2, 2 if rate else 0]
    keep, inv_keep = None, 1.0
    if rate:
        keep = philox_keep_mask(seed, b * h, s, kv_len, rate).view(
            b, h, s, kv_len)
        inv_keep = fa.dropout_thresh(rate)[1]
    ref = flash_attention_bwd_reference(q, k, v, out, lse, dout, mask,
                                        causal, keep, inv_keep)
    for a, a2, r in zip(grads, again, ref):
        assert torch.equal(a, a2)
        assert bool(torch.isfinite(a.float()).all())
        torch.testing.assert_close(a.float(), r.float(), atol=1e-2,
                                   rtol=1e-2)
        if mask_kind == "pad":
            assert bool((a[-1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(b3_cases()))
def test_bf16_b3_on_the_tensor_cores_matches_plain(cuda_device, name):
    """The bf16 B3 (``flash_bwd_fused_mma_kernel``) with B4 under dropout
    against ``flash_attention_bwd_reference`` fed the kernel's own out
    and lse and the same Philox mask, at 1e-2; a batch row whose keys are
    all masked gets exactly zero grads; two runs are bitwise equal; each
    call counts one B3 launch (and one B4 under dropout) and no B2."""
    check_b3_case(cuda_device, name, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(b3_cases()))
def test_fp16_b3_on_the_tensor_cores_matches_plain(cuda_device, name):
    """The fp16 instantiation of the same kernel, held the same way at
    the same shapes (BERT's among them), its launches also counted under
    ``flash_attention_bwd_fused.fp16``."""
    before = flash_attention_bwd_fused.fp16.launches
    check_b3_case(cuda_device, name, torch.float16)
    assert flash_attention_bwd_fused.fp16.launches == before + 2


@pytest.mark.cuda
def test_fp16_fits_and_choice_follow_bf16(cuda_device):
    """The fp16 B3 is the bf16 design with 16-bit tiles of the same size:
    the same shared memory at every shape, and the same dispatch rule."""
    for d, s, kv_len in ((64, 128, 128), (64, 21, 512), (64, 161, 161),
                         (128, 128, 128), (128, 129, 129)):
        assert fa.fused_smem_bytes(d, s, kv_len, torch.float16) == \
            fa.fused_smem_bytes(d, s, kv_len, torch.bfloat16)
        assert fa.use_fused_backward(d, s, kv_len, torch.float16) == \
            fa.use_fused_backward(d, s, kv_len, torch.bfloat16)


def nonfinite_by_head(t):
    """[b, h] bool: whether each (batch, head) slice of a ``[b, n, h, d]``
    tensor holds a non-finite value."""
    return ~torch.isfinite(t.float()).all(dim=3).all(dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("path,s,causal,rate", [
    ("b2", 256, True, 0.0), ("b2", 200, False, 0.1), ("b3", 128, False, 0.1),
    ("b3", 65, True, 0.0)])
def test_fp16_kernels_propagate_non_finite_values(cuda_device, path, s,
                                                  causal, rate):
    """An inf in dO (the overflow a loss scale makes) gives non-finite
    dq, dk and dv from the kernels in exactly the (batch, head) slices
    where the plain version's are, and a NaN in q gives a non-finite out
    and lse in exactly the slices where the plain forward's are: no
    running max, masking guard or ex2 turns them finite, so the engine's
    overflow check sees what the plain path would."""
    dtype = torch.float16
    q, k, v, mask = make_inputs(s + 7, 2, s, s, 4, 64)
    t = [torch.from_numpy(x).to(cuda_device, dtype) for x in (q, k, v)]
    m = torch.from_numpy(mask).to(cuda_device)
    seed = (torch.tensor([s, 3], dtype=torch.int32, device=cuda_device)
            if rate else None)
    keep, inv_keep = None, 1.0
    if rate:
        keep = philox_keep_mask(seed, 8, s, s, rate).view(2, 4, s, s)
        inv_keep = fa.dropout_thresh(rate)[1]
    out, lse = flash_attention_fwd(*t, m, causal, rate, seed)
    dout = torch.randn(2, s, 4, 64, generator=torch.Generator()
                       .manual_seed(s)).to(cuda_device, dtype)
    dout[0, s // 3, 1, 5] = float("inf")
    grads = backward_by_kernels(path, *t, out, lse, dout, m, causal, rate,
                                seed)
    ref = flash_attention_bwd_reference(*t, out, lse, dout, m, causal, keep,
                                        inv_keep)
    for g, r in zip(grads, ref):
        assert bool(nonfinite_by_head(r)[0, 1])
        assert torch.equal(nonfinite_by_head(g), nonfinite_by_head(r))

    qn = t[0].clone()
    qn[0, s // 2, 2, 7] = float("nan")
    out, lse = flash_attention_fwd(qn, t[1], t[2], m, causal, rate, seed)
    ref_out, ref_lse = flash_attention_reference(qn, t[1], t[2], m, causal,
                                                 keep, inv_keep)
    assert bool(nonfinite_by_head(ref_out)[0, 2])
    assert torch.equal(nonfinite_by_head(out), nonfinite_by_head(ref_out))
    assert torch.equal(~torch.isfinite(lse), ~torch.isfinite(ref_lse))


@pytest.mark.cuda
def test_fp16_launches_are_counted_per_dtype(cuda_device):
    """An fp16 launch adds one to the wrapper's count and to its fp16
    count (and B4's under dropout); a bf16 launch only to the first."""
    q, k, v, mask = make_inputs(3, 2, 128, 128, 4, 64)
    counters = (flash_attention_fwd, fa.in_kernel_dropout)
    seed = torch.tensor([1, 2], dtype=torch.int32, device=cuda_device)
    for dtype, fp16 in ((torch.bfloat16, 0), (torch.float16, 1)):
        t = [torch.from_numpy(x).to(cuda_device, dtype) for x in (q, k, v)]
        before = [(c.launches, c.fp16.launches) for c in counters]
        flash_attention_fwd(*t, None, True, 0.1, seed)
        assert [(c.launches - a, c.fp16.launches - b) for c, (a, b)
                in zip(counters, before)] == [(1, fp16)] * 2


@pytest.mark.cuda
def test_bf16_b3_raises_on_misaligned_views(cuda_device):
    """The bf16 B3 copies q, k, v and dO in 16-byte chunks with cp.async:
    a view off 16-byte alignment, or with a head stride that is not a
    multiple of 8 elements, is refused with a ValueError naming B3 and
    nothing is launched; an aligned copy goes through."""
    b, s, h, d = 1, 64, 2, 64
    g = torch.Generator().manual_seed(0)
    k, v, dout = (torch.randn(b, s, h, d, generator=g)
                  .to(cuda_device, torch.bfloat16) for _ in range(3))
    base = torch.randn(b * s * h * d + 4, generator=g).to(cuda_device,
                                                          torch.bfloat16)
    shifted = base[4:].view(b, s, h, d)        # 8 bytes past alignment
    wide = torch.randn(b, s, h, d + 4, generator=g).to(
        cuda_device, torch.bfloat16)[..., :d]  # head stride d + 4
    for bad in (shifted, wide):
        out, lse = flash_attention_fwd(bad.clone(), k, v, causal=True)
        before = flash_attention_bwd_fused.launches
        for args in ((bad, k, v, dout), (k, bad, v, dout), (k, v, bad, dout),
                     (k, v, dout, bad)):
            with pytest.raises(ValueError, match="bf16 B3"):
                flash_attention_bwd_fused(*args[:3], out, lse, args[3], None,
                                          True)
        assert flash_attention_bwd_fused.launches == before
        flash_attention_bwd_fused(bad.clone(), k, v, out, lse, dout, None,
                                  True)
        assert flash_attention_bwd_fused.launches == before + 1


@pytest.mark.cuda
def test_bf16_backward_wrappers_raise_on_misaligned_views(cuda_device):
    """The bf16 B2a and B2b copy 16-byte chunks with cp.async: a q whose
    base is not 16-byte aligned, or whose head stride is not a multiple
    of 8 elements, is refused, never copied or sent elsewhere."""
    b, s, h, d = 1, 64, 2, 64
    g = torch.Generator().manual_seed(0)
    k, v, dout = (torch.randn(b, s, h, d, generator=g)
                  .to(cuda_device, torch.bfloat16) for _ in range(3))
    base = torch.randn(b * s * h * d + 4, generator=g).to(cuda_device,
                                                          torch.bfloat16)
    shifted = base[4:].view(b, s, h, d)        # 8 bytes past alignment
    wide = torch.randn(b, s, h, d + 4, generator=g).to(
        cuda_device, torch.bfloat16)[..., :d]  # head stride d + 4
    for q in (shifted, wide):
        assert not fa.mma_aligned(q)
        out, lse = flash_attention_fwd(q.clone(), k, v, causal=True)
        for fn in (flash_attention_bwd_dq, flash_attention_bwd_dkv):
            with pytest.raises(ValueError, match="16-byte aligned"):
                fn(q, k, v, out, lse, dout, None, True)
    assert fa.mma_aligned(k, v, dout)


@pytest.mark.cuda
def test_bf16_forward_raises_on_misaligned_views(cuda_device):
    """The bf16 B1 copies q, k and v in 16-byte chunks with cp.async: a
    tensor whose base is not 16-byte aligned, or whose head stride is not
    a multiple of 8 elements, is refused with a ValueError naming B1 and
    nothing is launched; the aligned views and fp32 go through."""
    b, s, h, d = 1, 64, 2, 64
    g = torch.Generator().manual_seed(0)
    k, v = (torch.randn(b, s, h, d, generator=g)
            .to(cuda_device, torch.bfloat16) for _ in range(2))
    base = torch.randn(b * s * h * d + 4, generator=g).to(cuda_device,
                                                          torch.bfloat16)
    shifted = base[4:].view(b, s, h, d)        # 8 bytes past alignment
    wide = torch.randn(b, s, h, d + 4, generator=g).to(
        cuda_device, torch.bfloat16)[..., :d]  # head stride d + 4
    before = flash_attention_fwd.launches
    for bad in (shifted, wide):
        for args in ((bad, k, v), (k, bad, v), (k, v, bad)):
            with pytest.raises(ValueError, match="bf16 B1"):
                flash_attention_fwd(*args, causal=True)
    assert flash_attention_fwd.launches == before
    flash_attention_fwd(shifted.clone(), k, v, causal=True)
    flash_attention_fwd(wide.float(), k.float(), v.float(), causal=True)
    assert flash_attention_fwd.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_keep_mask_drawn_by_b1_equals_plain(cuda_device, dtype):
    """With q = 0 and V the identity over kv_len = head_dim keys, B1's
    output is keep · inv_keep / kv_len: its mask is the plain one, from
    the fp32 kernel and from the bf16 one."""
    q = torch.zeros(1, 512, 4, 64, device=cuda_device, dtype=dtype)
    k = torch.randn(1, 64, 4, 64, device=cuda_device).to(dtype)
    v = torch.eye(64, device=cuda_device)[None, :, None, :].expand(
        1, 64, 4, 64).contiguous().to(dtype)
    seed = torch.tensor([3, 4], dtype=torch.int32, device=cuda_device)
    out, _ = flash_attention_fwd(q, k, v, None, False, 0.3, seed)
    kept = out.permute(0, 2, 1, 3).reshape(4, 512, 64) > 0
    assert torch.equal(kept, philox_keep_mask(seed, 4, 512, 64, 0.3))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,kv_len,causal,h0,total", [
    (8, 16, 1024, 1024, True, 0, None),     # GPT-2's training attention
    (64, 16, 128, 128, False, 0, None),     # BERT's
    (1, 8, 100, 201, False, 0, None),       # 7 words a row: word stores
    (2, 2, 300, 300, True, 2, 6),           # a head range of 6 heads
    (1, 4, 65, 65, True, 0, None),
    (1, 4, 128, 256, True, 0, None)],
    ids=["train", "bert", "kv201", "head_range", "s65", "causal_kv_gt_s"])
def test_keep_bits_kernel_equals_plain(cuda_device, b, h, s, kv_len, causal,
                                       h0, total):
    """B4's words equal ``philox_keep_bits``'s bitwise (kv_len not a
    multiple of 32, causal, a head offset into more heads), two draws are
    equal, and each draw adds one to the kernel's count."""
    seed = torch.tensor([s, 7 * kv_len + 1], dtype=torch.int32,
                        device=cuda_device)
    before = fa.draw_keep_bits.launches
    bits = fa.draw_keep_bits(seed, b, h, s, kv_len, 0.1, causal, h0, total)
    again = fa.draw_keep_bits(seed, b, h, s, kv_len, 0.1, causal, h0, total)
    assert fa.draw_keep_bits.launches == before + 2
    heads = fa.drop_heads(b, h, h0, total, cuda_device)
    plain = fa.philox_keep_bits(seed, b * h, s, kv_len, 0.1, heads, causal)
    assert bits.dtype == torch.int32 and bits.shape == plain.shape
    assert torch.equal(bits, plain) and torch.equal(bits, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("s,causal", [(128, False), (256, True)],
                         ids=["s128", "s256_causal"])
def test_kernels_given_the_bits_equal_the_seed_alone(cuda_device, dtype, s,
                                                     causal):
    """B1 given B4's bits gives bitwise the outputs it gives from the seed
    alone (where it draws first); B2a+B2b and B3 (where it fits), whose
    one dropout input is the bits, give bitwise the same grads on bits
    drawn again from the seed, and draw nothing themselves."""
    q, k, v, mask = make_inputs(s + causal, 2, s, s, 4, 64)
    t = [torch.from_numpy(x).to(cuda_device, dtype) for x in (q, k, v)]
    m = torch.from_numpy(mask).to(cuda_device)
    dout = torch.randn(2, s, 4, 64, generator=torch.Generator()
                       .manual_seed(s)).to(cuda_device, dtype)
    seed = torch.tensor([s, 5], dtype=torch.int32, device=cuda_device)
    bits = fa.draw_keep_bits(seed, 2, 4, s, s, 0.1, causal)
    out, lse = flash_attention_fwd(*t, m, causal, 0.1, seed)
    out_b, lse_b = flash_attention_fwd(*t, m, causal, 0.1, keep_bits=bits)
    assert torch.equal(out, out_b) and torch.equal(lse, lse_b)
    args = (*t, out, lse, dout, m, causal, 0.1)
    fused = fa.fused_backward_fits(64, s, s, dtype)

    def backward(**kw):
        grads = [(flash_attention_bwd_dq(*args, **kw),)
                 + flash_attention_bwd_dkv(*args, **kw)]
        if fused:
            grads.append(flash_attention_bwd_fused(*args, **kw))
        return grads

    draws = fa.draw_keep_bits.launches
    by_bits = backward(keep_bits=bits)
    assert fa.draw_keep_bits.launches == draws
    by_seed = backward(keep_bits=keep_bits_of(seed, t[0], t[1], causal, 0.1))
    assert fa.draw_keep_bits.launches == draws + 1
    for grads_b, grads_s in zip(by_bits, by_seed):
        for g, g2 in zip(grads_b, grads_s):
            assert torch.equal(g, g2)


@pytest.mark.cuda
@pytest.mark.parametrize("telemetry", [False, True],
                         ids=["telemetry_off", "telemetry_on"])
def test_train_batch_syncs_only_at_the_print_cadence(cuda_device, telemetry,
                                                     tmp_path):
    """``train_batch`` fetches nothing from the card between prints: no
    synchronizing call (CUDA sync debug mode warns at each) except the
    loss fetch of the step that prints — with telemetry on too (events,
    host spans, step metrics, the throughput timer, the trigger poll)."""
    config = GPT2Config(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, max_position_embeddings=128)
    train = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
             "steps_per_print": 3, "gradient_clipping": 1.0,
             "optimizer": {"type": "Lamb", "params": {"lr": 1e-3}},
             "bf16": {"enabled": True}}
    if telemetry:
        train["telemetry"] = {"enabled": True, "run_dir": str(tmp_path),
                              "trace": True}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(config), model_parameters=random_params(config, 0),
        config=train, device=cuda_device)
    rng = np.random.RandomState(0)
    batches = [{"input_ids": rng.randint(0, 512, size=(2, 128))}
               for _ in range(8)]
    it = iter(batches)
    engine.train_batch(it)   # warm-up: kernels, cuBLAS, allocator
    torch.cuda.synchronize()
    counts = []
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for _ in range(3):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                engine.train_batch(it)
            counts.append(sum("synchroniz" in str(w.message)
                              for w in caught))
    finally:
        torch.cuda.set_sync_debug_mode(previous)
    # global steps 2, 3, 4: step 3 prints
    assert counts == [0, 1, 0]
    engine.close()


@pytest.mark.cuda
def test_integrity_rides_the_steps_one_fetch_on_the_card(cuda_device,
                                                         tmp_path,
                                                         monkeypatch):
    """With ``resilience.integrity`` armed (this process as rank 0 of a
    fleet of 2), each step still makes exactly one synchronizing copy,
    as with resilience alone: the state fingerprint of the step after the
    print cadence rides that copy, and lands in the run dir."""
    from deepspeed_tpu_torch.resilience import integrity as integ

    monkeypatch.setenv("DS_PROCESS_ID", "0")
    monkeypatch.setenv("DS_NUM_PROCESSES", "2")
    monkeypatch.delenv("DS_TELEMETRY_DIR", raising=False)
    config = GPT2Config(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, max_position_embeddings=128)
    counts = {}
    for integrity in (False, True):
        run_dir = str(tmp_path / f"integrity{int(integrity)}")
        train = {"train_batch_size": 2, "steps_per_print": 3,
                 "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                 "bf16": {"enabled": True},
                 "resilience": {"enabled": True, "integrity": integrity},
                 "telemetry": {"enabled": True, "run_dir": run_dir}}
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=GPT2LMHead(config),
            model_parameters=random_params(config, 0), config=train,
            device=cuda_device, dist_init_required=False)
        assert (engine._integrity is not None) == integrity
        rng = np.random.RandomState(0)
        it = iter([{"input_ids": rng.randint(0, 512, size=(2, 128))}
                   for _ in range(4)])
        engine.train_batch(it)   # warm-up: kernels, cuBLAS, allocator
        torch.cuda.synchronize()
        counts[integrity] = []
        previous = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(3):
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    engine.train_batch(it)
                counts[integrity].append(
                    sum("synchroniz" in str(w.message) for w in caught))
        finally:
            torch.cuda.set_sync_debug_mode(previous)
        if integrity:
            # the states steps 1 and 4 start from: labels 0 and 3
            assert sorted(integ.read_fleet_fingerprints(run_dir)[0]) == \
                [0, 3]
        engine.close()
    assert counts[True] == counts[False] == [1, 1, 1]


@pytest.mark.cuda
def test_fingerprint_on_the_card_equals_the_cpus(cuda_device):
    """The fleet fingerprint of the same leaves on the card and on the
    CPU, without a synchronizing call on the card: a 32-bit leaf of more
    than one run (its full rows straight from the leaf, its tail packed
    with the next leaf), 16-bit, bool, 8-byte and all-ones leaves, and a
    Python int."""
    from deepspeed_tpu_torch.resilience.fingerprint import CHUNK, fingerprint

    g = torch.Generator().manual_seed(5)
    leaves = [torch.randn(CHUNK + 5 * 4096 + 77, generator=g),
              torch.randn(7000, generator=g),
              torch.randn(3 * 4096 + 1, generator=g).bfloat16(),
              torch.randint(-2 ** 31, 2 ** 31 - 1, (100,), generator=g,
                            dtype=torch.int32),
              torch.rand(1000, generator=g) < 0.5,
              torch.randn(333, generator=g, dtype=torch.float64),
              torch.full((CHUNK,), -1, dtype=torch.int32), 7]
    on_card = [x.to(cuda_device) if torch.is_tensor(x) else x
               for x in leaves]
    fingerprint(on_card)     # warm-up: the byte weights, cuBLAS
    torch.cuda.synchronize()
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = fingerprint(on_card)
    finally:
        torch.cuda.set_sync_debug_mode(previous)
    assert not [w for w in caught if "synchroniz" in str(w.message)]
    assert got.device.type == "cuda" and got.dtype == torch.int64
    assert int(got) == int(fingerprint(leaves))


@pytest.mark.cuda
def test_fp16_engine_skips_a_forced_overflow_through_the_fp16_kernels(
        cuda_device):
    """Tiny GPT-2 in fp16 (dropout 0.1, seq 256: B1, B2a+B2b and B4, all
    in fp16) under a dynamic loss scale: an inf written into one compute
    parameter makes the next step's gradients non-finite on the card, so
    that step is skipped with the master and both moments bitwise
    unchanged and the LR schedule not stepped; the steps around it apply.
    Every attention launch is an fp16 one, and each step makes exactly
    one synchronizing copy (the overflow flag and the loss)."""
    config = GPT2Config(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, max_position_embeddings=256,
                        embd_dropout=0.1, attn_dropout=0.1,
                        resid_dropout=0.1)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(config), model_parameters=random_params(config, 0),
        config={"train_batch_size": 2, "steps_per_print": 10 ** 9,
                "optimizer": {"type": "Lamb", "params": {"lr": 1e-3}},
                "scheduler": {"type": "WarmupLR",
                              "params": {"warmup_num_steps": 10}},
                "zero_optimization": {"stage": 2},
                "fp16": {"enabled": True, "initial_scale_power": 16,
                         "hysteresis": 1}}, device=cuda_device)
    rng = np.random.RandomState(0)
    batches = [{"input_ids": rng.randint(0, 512, size=(2, 256))}
               for _ in range(5)]
    engine.train_batch(iter(batches[:1]))   # warm-up
    counters = (flash_attention_fwd, flash_attention_bwd_dq,
                flash_attention_bwd_dkv, fa.in_kernel_dropout)
    for c in counters:
        c.launches = c.fp16.launches = 0
    torch.cuda.synchronize()
    syncs = []
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for i, batch in enumerate(batches[1:]):
            if i == 1:
                before = [engine.master.clone(),
                          engine.opt_state.exp_avg.clone(),
                          engine.opt_state.exp_avg_sq.clone()]
                lr = engine.get_lr()[0]
                scale, skipped = engine.loss_scale, engine.skipped_steps
                with torch.no_grad():
                    engine.params["blocks"]["layer_0"]["fc1"]["bias"][0] = \
                        float("inf")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                engine.train_batch(iter([batch]))
            syncs.append(sum("synchroniz" in str(w.message)
                             for w in caught))
            if i == 1:
                assert engine.skipped_steps == skipped + 1
                assert all(torch.equal(a, b) for a, b in zip(before, (
                    engine.master, engine.opt_state.exp_avg,
                    engine.opt_state.exp_avg_sq)))
                assert engine.get_lr()[0] == lr
                assert engine.loss_scale == scale / 2
    finally:
        torch.cuda.set_sync_debug_mode(previous)
    assert syncs == [1, 1, 1, 1]
    assert engine.skipped_steps == skipped + 1
    assert bool(torch.isfinite(engine.master).all())
    assert engine.get_lr()[0] != lr
    assert [c.launches for c in counters] == [8, 8, 8, 24]
    assert [c.fp16.launches for c in counters] == [8, 8, 8, 24]


@pytest.mark.cuda
def test_checkpoint_resume_is_bitwise_through_the_kernels(cuda_device,
                                                           tmp_path):
    """Tiny GPT-2 in bf16 with dropout 0.1 at all three sites, seq 256
    (B1 and B2a+B2b, B4 inside them), Lamb under WarmupLR, the
    dataloader: 2 steps, an async save, 2 more steps; a fresh engine
    from other weights loads and takes 2 steps.  Losses and the final
    master are bitwise run A's, and both runs launch one B1, B2a and B2b
    per layer per step: the kernels' results do not move across a
    checkpoint."""
    config = GPT2Config(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, max_position_embeddings=256,
                        embd_dropout=0.1, attn_dropout=0.1,
                        resid_dropout=0.1)
    rng = np.random.RandomState(0)
    data = [{"input_ids": row} for row in rng.randint(0, 512, (8, 256))]
    ds_config = {"train_batch_size": 2, "steps_per_print": 10 ** 9,
                 "optimizer": {"type": "Lamb", "params": {"lr": 1e-3}},
                 "scheduler": {"type": "WarmupLR",
                               "params": {"warmup_num_steps": 4}},
                 "zero_optimization": {"stage": 2},
                 "bf16": {"enabled": True}}
    counters = (flash_attention_fwd, flash_attention_bwd_dq,
                flash_attention_bwd_dkv)

    def engine(seed):
        return deepspeed_tpu_torch.initialize(
            model=GPT2LMHead(config),
            model_parameters=random_params(config, seed),
            config=dict(ds_config), device=cuda_device,
            training_data=data)[0]

    def steps(e, n):
        for counter in counters:
            counter.launches = 0
        losses = [float(e.train_batch()) for _ in range(n)]
        assert [c.launches for c in counters] == [2 * n] * 3
        return losses

    a = engine(0)
    steps(a, 2)
    a.save_checkpoint(str(tmp_path))
    want = steps(a, 2)
    a.wait_checkpoint(str(tmp_path))
    b = engine(1)
    b.load_checkpoint(str(tmp_path), strict=True)
    assert steps(b, 2) == want
    assert torch.equal(a.master, b.master)

def sparse_layouts():
    """name -> (layout, s, heads, d, causal)."""
    import random
    random.seed(0)
    rs = np.random.RandomState(0)
    per_head = (rs.rand(4, 16, 16) < 0.3).astype(np.int64)
    per_head[1, 3] = 0          # a q block with no active key block
    per_head[:, 5] = 0
    return {
        "fixed_uni_blk128": (FixedSparsityConfig(
            num_heads=4, block=128, num_local_blocks=4, num_global_blocks=1,
            attention="unidirectional").make_layout(1024), 1024, 4, 64, True),
        "bigbird_blk64": (BigBirdSparsityConfig(
            num_heads=4, block=64, num_random_blocks=1,
            num_sliding_window_blocks=3, num_global_blocks=1)
            .make_layout(1024)[:1], 1024, 4, 64, False),
        "bigbird_blk512": (BigBirdSparsityConfig(
            num_heads=2, block=512, num_random_blocks=1,
            num_sliding_window_blocks=3, num_global_blocks=1)
            .make_layout(4096), 4096, 2, 64, False),
        "per_head_empty_rows_causal": (per_head, 512, 4, 64, True),
        "per_head_d128": (per_head, 512, 4, 128, False),
        "blk16": (FixedSparsityConfig(
            num_heads=4, block=16, num_local_blocks=4,
            attention="unidirectional").make_layout(512), 512, 4, 64, True),
        "blk24_upper": (np.triu(np.ones((1, 8, 8), np.int64)), 192, 2, 64,
                        True),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("name", sorted(sparse_layouts()))
def test_block_sparse_kernels_match_plain(cuda_device, dtype, name):
    """B5a and B5b against their plain versions on fused-QKV views: out
    and lse (fp32 2e-5, bf16 and fp16 2e-2), the gradients (5e-4 / 1e-2)
    from the
    kernel's own out and lse; rows with no active block give exactly
    zero out and dq; a second backward is bitwise equal; each wrapper
    counts one launch per call."""
    layout, s, h, d, causal = sparse_layouts()[name]
    g = torch.Generator().manual_seed(len(name))
    qkv = torch.randn(2, s, 3, h, d, generator=g).to(cuda_device, dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    dout = torch.randn(2, s, h, d, generator=g).to(cuda_device, dtype)
    before = (fbs.flash_block_sparse_fwd.launches,
              fbs.flash_block_sparse_bwd.launches)
    out, lse = fbs.flash_block_sparse_fwd(q, k, v, layout, causal)
    grads = fbs.flash_block_sparse_bwd(q, k, v, out, lse, dout, layout,
                                       causal)
    again = fbs.flash_block_sparse_bwd(q, k, v, out, lse, dout, layout,
                                       causal)
    torch.cuda.synchronize()
    assert (fbs.flash_block_sparse_fwd.launches,
            fbs.flash_block_sparse_bwd.launches) == (before[0] + 1,
                                                     before[1] + 2)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    ref_out, ref_lse = fbs.flash_block_sparse_reference(q, k, v, layout,
                                                        causal)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)
    ref = fbs.flash_block_sparse_bwd_reference(q, k, v, out, lse, dout,
                                               layout, causal)
    for a, a2, r in zip(grads, again, ref):
        assert torch.equal(a, a2)
        torch.testing.assert_close(a.float(), r.float(),
                                   atol=GRAD_TOLS[dtype],
                                   rtol=GRAD_TOLS[dtype])
    if name.startswith("per_head"):
        blk = s // layout.shape[1]
        rows = slice(3 * blk, 4 * blk)       # head 1, q block 3: empty
        assert not out[:, rows, 1].any() and not grads[0][:, rows, 1].any()
        assert bool((lse.view(2, h, s)[:, 1, rows] == fbs.NEG_INF).all())


def agg_layouts():
    """name -> (layout, s, heads, d, G, causal)."""
    import random
    random.seed(1)
    rs = np.random.RandomState(1)
    per_head = (rs.rand(4, 16, 16) < 0.3).astype(np.int64)
    per_head[:, :, 0] = 1
    per_head[1, 4:8] = 0        # head 1: super-row 1 of 4 blocks is empty
    per_head[2, 9] = 0          # head 2: an empty row in an active super-row
    return {
        "bert_fixed_blk128_G4": (FixedSparsityConfig(
            num_heads=4, block=128, num_local_blocks=4, num_global_blocks=1,
            attention="bidirectional", different_layout_per_head=True,
            num_different_global_patterns=4).make_layout(1024), 1024, 4, 64,
            4, False),
        "bigbird_blk64_G4": (BigBirdSparsityConfig(
            num_heads=4, block=64, num_random_blocks=1,
            num_sliding_window_blocks=3, num_global_blocks=1)
            .make_layout(1024)[:1], 1024, 4, 64, 4, False),
        "per_head_blk16_G4_causal": (per_head, 256, 4, 64, 4, True),
        "per_head_blk32_G2_d128": (per_head, 512, 4, 128, 2, False),
        "blk24_G3_causal": (np.tril(np.ones((1, 6, 6), np.int64)), 144, 2,
                            64, 3, True),
        "blk256_G2": (np.tril(np.ones((1, 4, 4), np.int64)), 1024, 2, 64, 2,
                      True),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("name", sorted(agg_layouts()))
def test_super_tile_kernels_match_plain_and_b5(cuda_device, dtype, name):
    """B6a, B6b and B6c against their plain versions on fused-QKV views
    (out and lse at 2e-5 / 2e-2 with the MAX_FLOOR and NEG_INF rows
    equal, grads at 5e-4 / 1e-2 from the kernel's own out and lse),
    against B5 on the same inputs (the same function: out and grads at
    the same bounds), a second run bitwise equal, one launch per call of
    each wrapper."""
    layout, s, h, d, G, causal = agg_layouts()[name]
    g = torch.Generator().manual_seed(len(name))
    qkv = torch.randn(2, s, 3, h, d, generator=g).to(cuda_device, dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    dout = torch.randn(2, s, h, d, generator=g).to(cuda_device, dtype)
    counters = (fbs.flash_block_sparse_agg_fwd,
                fbs.flash_block_sparse_agg_bwd_dq,
                fbs.flash_block_sparse_agg_bwd_dkv)
    before = [c.launches for c in counters]
    out, lse = fbs.flash_block_sparse_agg_fwd(q, k, v, layout, G, causal)
    grads = fbs.flash_block_sparse_agg_bwd(q, k, v, out, lse, dout, layout,
                                           G, causal)
    again = fbs.flash_block_sparse_agg_bwd(q, k, v, out, lse, dout, layout,
                                           G, causal)
    out2, lse2 = fbs.flash_block_sparse_agg_fwd(q, k, v, layout, G, causal)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2, 2]
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    gtol = GRAD_TOLS[dtype]
    ref_out, ref_lse = fbs.flash_block_sparse_agg_reference(q, k, v, layout,
                                                            G, causal)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)
    for special in (fbs.MAX_FLOOR, fbs.NEG_INF):
        assert torch.equal(lse == special, ref_lse == special)
    ref = fbs.flash_block_sparse_agg_bwd_reference(q, k, v, out, lse, dout,
                                                   layout, G, causal)
    for a, a2, r in zip(grads, again, ref):
        assert torch.equal(a, a2)
        torch.testing.assert_close(a.float(), r.float(), atol=gtol,
                                   rtol=gtol)
    b5_out, b5_lse = fbs.flash_block_sparse_fwd(q, k, v, layout, causal)
    b5_grads = fbs.flash_block_sparse_bwd(q, k, v, b5_out, b5_lse, dout,
                                          layout, causal)
    torch.testing.assert_close(out.float(), b5_out.float(), atol=tol,
                               rtol=tol)
    for a, r in zip(grads, b5_grads):
        torch.testing.assert_close(a.float(), r.float(), atol=gtol,
                                   rtol=gtol)
    if name.startswith("per_head_blk16"):
        blk = s // layout.shape[1]
        rows = slice(4 * blk, 8 * blk)       # head 1's empty super-row
        assert not out[:, rows, 1].any() and not grads[0][:, rows, 1].any()
        assert bool((lse.view(2, h, s)[:, 1, rows] == fbs.NEG_INF).all())
        empty = slice(9 * blk, 10 * blk)     # head 2's empty row
        assert bool((lse.view(2, h, s)[:, 2, empty] == fbs.MAX_FLOOR).all())


def agg_edges():
    """name -> (layout, b, s, heads, d, G, causal): the bf16 B6b and B6c
    edges of the tensor-core kernels.  blk 24 with G = 3 (n = 72: the
    64-wide tiles straddle groups and the super-tile's edge); blk 16 with
    G = 4, causal, an empty super-row and an empty row inside an active
    super-row (lse MAX_FLOOR); head_dim 128; G = 5 (25 mask bits); the
    BERT layout at s=1024 with all 16 heads (every visited tile full)."""
    rs = np.random.RandomState(7)
    per_head = (rs.rand(4, 16, 16) < 0.3).astype(np.int64)
    per_head[:, :, 0] = 1
    per_head[1, 4:8] = 0
    per_head[2, 9] = 0
    g5 = (rs.rand(2, 10, 10) < 0.35).astype(np.int64)
    return {
        "blk24_G3_causal": (np.tril(np.ones((1, 6, 6), np.int64)), 2, 144,
                            4, 64, 3, True),
        "blk16_G4_causal_empty_rows": (per_head, 2, 256, 4, 64, 4, True),
        "blk32_G2_d128_causal": (per_head, 1, 512, 4, 128, 2, True),
        "blk16_G5": (g5, 1, 160, 2, 64, 5, False),
        "bert_layout_s1024": (FixedSparsityConfig(
            num_heads=16, block=128, num_local_blocks=4,
            num_global_blocks=1, attention="bidirectional",
            different_layout_per_head=True,
            num_different_global_patterns=4).make_layout(1024), 2, 1024, 16,
            64, 4, False),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(agg_edges()))
def test_bf16_super_tile_backward_edges(cuda_device, name):
    """The bf16 B6b and B6c (tensor cores) on fused-QKV views against
    the plain version at 1e-2, one launch each per call, two runs
    bitwise equal, and exactly 0 where no pair is seen: dq of a row that
    sees no key, dk and dv of a key that no row sees."""
    layout, b, s, h, d, G, causal = agg_edges()[name]
    g = torch.Generator().manual_seed(len(name))
    qkv = torch.randn(b, s, 3, h, d, generator=g).to(cuda_device,
                                                     torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    dout = torch.randn(b, s, h, d, generator=g).to(cuda_device,
                                                   torch.bfloat16)
    out, lse = fbs.flash_block_sparse_agg_fwd(q, k, v, layout, G, causal)
    counters = (fbs.flash_block_sparse_agg_bwd_dq,
                fbs.flash_block_sparse_agg_bwd_dkv)
    before = [c.launches for c in counters]
    grads = fbs.flash_block_sparse_agg_bwd(q, k, v, out, lse, dout, layout,
                                           G, causal)
    again = fbs.flash_block_sparse_agg_bwd(q, k, v, out, lse, dout, layout,
                                           G, causal)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [2, 2]
    ref = fbs.flash_block_sparse_agg_bwd_reference(q, k, v, out, lse, dout,
                                                   layout, G, causal)
    for a, a2, r in zip(grads, again, ref):
        assert torch.equal(a, a2)
        torch.testing.assert_close(a.float(), r.float(), atol=1e-2,
                                   rtol=1e-2)
    visible, _ = fbs.expand_layout(layout, s, causal, cuda_device)
    visible = visible.expand(h, s, s)
    no_key = ~visible.any(-1).T          # [s, h]: rows that see no key
    no_row = ~visible.any(-2).T          # [s, h]: keys no row sees
    assert not grads[0][:, no_key].any()
    assert not grads[1][:, no_row].any() and not grads[2][:, no_row].any()
    if name.startswith("blk16_G4"):
        assert bool(no_key[4 * 16:8 * 16, 1].all())   # the empty super-row
        assert bool((lse.view(b, h, s)[:, 2, 9 * 16:10 * 16]
                     == fbs.MAX_FLOOR).all())


@pytest.mark.cuda
def test_bf16_super_tile_backward_does_not_depend_on_the_launch_order(
        cuda_device):
    """Each block of B6b and B6c owns its output rows, so the launch
    order changes when a block runs, not what it writes: grid order and
    the longest-first order give bitwise-equal gradients."""
    layout = FixedSparsityConfig(
        num_heads=4, block=128, num_local_blocks=4, num_global_blocks=1,
        attention="bidirectional", different_layout_per_head=True,
        num_different_global_patterns=4).make_layout(2048)
    b, s, h, d, G = 1, 2048, 4, 64, 4
    g = torch.Generator().manual_seed(3)
    q, k, v, dout = (torch.randn(b, s, h, d, generator=g)
                     .to(cuda_device, torch.bfloat16) for _ in range(4))
    out, lse = fbs.flash_block_sparse_agg_fwd(q, k, v, layout, G)
    sorted_grads = fbs.flash_block_sparse_agg_bwd(q, k, v, out, lse, dout,
                                                  layout, G)
    luts = fbs.device_luts(layout, cuda_device)
    key = (G, s // layout.shape[1], False)
    orders = luts.launch_order(*key)
    assert not torch.equal(orders[1], torch.arange(
        orders[1].numel(), dtype=torch.int32, device=cuda_device))
    luts._orders[key] = tuple(torch.arange(o.numel(), dtype=torch.int32,
                                           device=cuda_device)
                              for o in orders)
    try:
        grid_grads = fbs.flash_block_sparse_agg_bwd(q, k, v, out, lse, dout,
                                                    layout, G)
    finally:
        luts._orders[key] = orders
    for a, r in zip(sorted_grads, grid_grads):
        assert torch.equal(a, r)


@pytest.mark.cuda
def test_bf16_super_tile_backward_raises_on_misaligned_views(cuda_device):
    """The bf16 B6b and B6c copy q, k, v and dO in 16-byte chunks: a
    view whose base is not 16-byte aligned, or whose head stride is not
    a multiple of 8 elements, is refused with a ValueError naming the
    kernel and nothing is launched; aligned copies go through."""
    layout = np.ones((1, 4, 4), np.int64)
    b, s, h, d, G = 1, 128, 2, 64, 2
    g = torch.Generator().manual_seed(0)
    k, v, dout = (torch.randn(b, s, h, d, generator=g)
                  .to(cuda_device, torch.bfloat16) for _ in range(3))
    base = torch.randn(b * s * h * d + 4, generator=g).to(cuda_device,
                                                          torch.bfloat16)
    shifted = base[4:].view(b, s, h, d)        # 8 bytes past alignment
    wide = torch.randn(b, s, h, d + 4, generator=g).to(
        cuda_device, torch.bfloat16)[..., :d]  # head stride d + 4
    counters = (fbs.flash_block_sparse_agg_bwd_dq,
                fbs.flash_block_sparse_agg_bwd_dkv)
    for bad in (shifted, wide):
        out, lse = fbs.flash_block_sparse_agg_fwd(bad.clone(), k, v, layout,
                                                  G)
        before = [c.launches for c in counters]
        for args in ((bad, k, v, dout), (k, bad, v, dout), (k, v, bad, dout),
                     (k, v, dout, bad)):
            for fn, name in zip(counters, ("B6b", "B6c")):
                with pytest.raises(ValueError, match=f"bf16 {name}"):
                    fn(*args[:3], out, lse, args[3], layout, G)
        assert [c.launches for c in counters] == before
        fbs.flash_block_sparse_agg_bwd(bad.clone(), k, v, out, lse, dout,
                                       layout, G)
        assert [c.launches - n for c, n in zip(counters, before)] == [1, 1]


def b5b_edges():
    """name -> (layout, b, s, heads, d, causal): the bf16 B5b on the
    super-tile backward kernels at G = 1.  16- and 24-row blocks (one
    64-row part cut to the block), 256-row blocks (the sparse GPT-2
    layout: four parts, the global key columns walk the most tiles),
    512-row per-head BigBird (eight parts), block rows with no active
    block in a per-head layout, head_dim 128; causal and not."""
    rs = np.random.RandomState(5)
    per_head = (rs.rand(4, 16, 16) < 0.3).astype(np.int64)
    per_head[1, 3] = 0          # head 1, q block 3 attends nothing
    per_head[:, 5] = 0          # q block 5 attends nothing in any head
    return {
        "blk16_fixed_uni_causal": (FixedSparsityConfig(
            num_heads=4, block=16, num_local_blocks=4,
            attention="unidirectional").make_layout(512), 2, 512, 4, 64,
            True),
        "blk24_upper_causal": (np.triu(np.ones((1, 8, 8), np.int64)), 1,
                               192, 2, 64, True),
        "blk256_gpt2_layout_causal": (FixedSparsityConfig(
            num_heads=4, block=256, num_local_blocks=4, num_global_blocks=1,
            attention="unidirectional").make_layout(4096), 1, 4096, 4, 64,
            True),
        "blk512_bigbird_per_head": (BigBirdSparsityConfig(
            num_heads=2, block=512, num_random_blocks=1,
            num_sliding_window_blocks=3, num_global_blocks=1,
            different_layout_per_head=True).make_layout(4096), 1, 4096, 2,
            64, False),
        "blk32_per_head_empty_rows": (per_head, 2, 512, 4, 64, False),
        "blk32_per_head_empty_rows_d128_causal": (per_head, 1, 512, 4, 128,
                                                  True),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(b5b_edges()))
def test_bf16_b5b_on_the_tensor_cores_matches_plain(cuda_device, name):
    """The bf16 B5b (B6b's and B6c's tensor-core kernels at G = 1) on
    fused-QKV views against its plain version at 1e-2, from B5a's own out
    and lse (NEG_INF rows included); exactly 0 where no pair is seen; two
    runs bitwise equal and equal to a run in grid order; each call moves
    ``flash_block_sparse_bwd.launches`` by one and no B6 counter."""
    layout, b, s, h, d, causal = b5b_edges()[name]
    g = torch.Generator().manual_seed(len(name))
    qkv = torch.randn(b, s, 3, h, d, generator=g).to(cuda_device,
                                                     torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    dout = torch.randn(b, s, h, d, generator=g).to(cuda_device,
                                                   torch.bfloat16)
    out, lse = fbs.flash_block_sparse_fwd(q, k, v, layout, causal)
    counters = (fbs.flash_block_sparse_bwd, fbs.flash_block_sparse_agg_fwd,
                fbs.flash_block_sparse_agg_bwd_dq,
                fbs.flash_block_sparse_agg_bwd_dkv)
    before = [c.launches for c in counters]
    grads = fbs.flash_block_sparse_bwd(q, k, v, out, lse, dout, layout,
                                       causal)
    again = fbs.flash_block_sparse_bwd(q, k, v, out, lse, dout, layout,
                                       causal)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [2, 0, 0, 0]
    luts = fbs.device_luts(layout, cuda_device)
    key = (1, s // layout.shape[1], causal)
    orders = luts.launch_order(*key)
    luts._orders[key] = tuple(torch.arange(o.numel(), dtype=torch.int32,
                                           device=cuda_device)
                              for o in orders)
    try:
        grid = fbs.flash_block_sparse_bwd(q, k, v, out, lse, dout, layout,
                                          causal)
    finally:
        luts._orders[key] = orders
    ref = fbs.flash_block_sparse_bwd_reference(q, k, v, out, lse, dout,
                                               layout, causal)
    for a, a2, a3, r in zip(grads, again, grid, ref):
        assert torch.equal(a, a2) and torch.equal(a, a3)
        torch.testing.assert_close(a.float(), r.float(), atol=1e-2,
                                   rtol=1e-2)
    visible, _ = fbs.expand_layout(layout, s, causal, cuda_device)
    visible = visible.expand(h, s, s)
    no_key, no_row = ~visible.any(-1).T, ~visible.any(-2).T
    assert not grads[0][:, no_key].any()
    assert not grads[1][:, no_row].any() and not grads[2][:, no_row].any()
    if name.startswith("blk32_per_head"):
        assert bool((lse.view(b, h, s)[:, 1, 3 * 32:4 * 32]
                     == fbs.NEG_INF).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(agg_edges()))
def test_bf16_b6a_on_the_tensor_cores_matches_plain_and_b5a(cuda_device,
                                                            name):
    """The bf16 B6a (``agg_fwd_mma_kernel``) on fused-QKV views against
    its plain version (out and lse at 2e-2; the MAX_FLOOR and NEG_INF
    rows exactly, out 0 there) and against B5a on the same inputs (out
    at 2e-2, lse at 2e-2 where a row sees a pair); two runs bitwise
    equal and equal to a run in grid order; one launch per call."""
    layout, b, s, h, d, G, causal = agg_edges()[name]
    g = torch.Generator().manual_seed(len(name))
    qkv = torch.randn(b, s, 3, h, d, generator=g).to(cuda_device,
                                                     torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = fbs.flash_block_sparse_agg_fwd.launches
    out, lse = fbs.flash_block_sparse_agg_fwd(q, k, v, layout, G, causal)
    out2, lse2 = fbs.flash_block_sparse_agg_fwd(q, k, v, layout, G, causal)
    torch.cuda.synchronize()
    assert fbs.flash_block_sparse_agg_fwd.launches == before + 2
    luts = fbs.device_luts(layout, cuda_device)
    key = (G, s // layout.shape[1], causal)
    orders = luts.launch_order(*key)
    luts._orders[key] = tuple(torch.arange(o.numel(), dtype=torch.int32,
                                           device=cuda_device)
                              for o in orders)
    try:
        out3, lse3 = fbs.flash_block_sparse_agg_fwd(q, k, v, layout, G,
                                                    causal)
    finally:
        luts._orders[key] = orders
    for a, a2, a3 in ((out, out2, out3), (lse, lse2, lse3)):
        assert torch.equal(a, a2) and torch.equal(a, a3)
    ref_out, ref_lse = fbs.flash_block_sparse_agg_reference(q, k, v, layout,
                                                            G, causal)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=2e-2, rtol=2e-2)
    for special in (fbs.MAX_FLOOR, fbs.NEG_INF):
        assert torch.equal(lse == special, ref_lse == special)
    seen = (lse > fbs.MAX_FLOOR).view(b, h, s).transpose(1, 2)
    assert not out[~seen].any()
    b5_out, b5_lse = fbs.flash_block_sparse_fwd(q, k, v, layout, causal)
    torch.testing.assert_close(out.float(), b5_out.float(), atol=2e-2,
                               rtol=2e-2)
    both = (lse > fbs.MAX_FLOOR) & (b5_lse > fbs.MAX_FLOOR)
    assert torch.equal(lse > fbs.MAX_FLOOR, b5_lse > fbs.MAX_FLOOR)
    torch.testing.assert_close(lse[both], b5_lse[both], atol=2e-2,
                               rtol=2e-2)


def b5a_edges():
    """name -> (layout, b, s, heads, d, causal): the bf16 B5a on the
    super-tile forward kernel at G = 1, over the edges of b5b_edges() and
    a block row whose active blocks all lie above the diagonal (under
    causal its rows see nothing: lse MAX_FLOOR)."""
    above = np.tril(np.ones((1, 8, 8), np.int64))
    above[0, 2] = 0
    above[0, 2, 5] = 1          # block row 2: only block 5, above the diagonal
    return dict(b5b_edges(), blk64_row_above_diagonal_causal=(
        above, 2, 512, 2, 64, True))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(b5a_edges()))
def test_bf16_b5a_on_the_tensor_cores_matches_plain(cuda_device, name,
                                                    monkeypatch):
    """The bf16 B5a (B6a's tensor-core kernel at G = 1) on fused-QKV
    views against its plain version at 2e-2, its outputs allocated
    filled with NaN: the MAX_FLOOR and NEG_INF lse rows equal the plain
    version's exactly and out is 0 there; two runs bitwise equal and
    equal to a run in grid order; each call moves
    ``flash_block_sparse_fwd.launches`` by one and no B6 counter."""
    layout, b, s, h, d, causal = b5a_edges()[name]
    g = torch.Generator().manual_seed(len(name))
    qkv = torch.randn(b, s, 3, h, d, generator=g).to(cuda_device,
                                                     torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    luts = fbs.device_luts(layout, cuda_device)
    key = (1, s // layout.shape[1], causal)
    orders = luts.launch_order(*key)
    empty = torch.empty

    def nan_empty(*args, **kwargs):
        t = empty(*args, **kwargs)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    monkeypatch.setattr(torch, "empty", nan_empty)
    counters = (fbs.flash_block_sparse_fwd, fbs.flash_block_sparse_agg_fwd,
                fbs.flash_block_sparse_agg_bwd_dq,
                fbs.flash_block_sparse_agg_bwd_dkv)
    before = [c.launches for c in counters]
    out, lse = fbs.flash_block_sparse_fwd(q, k, v, layout, causal)
    out2, lse2 = fbs.flash_block_sparse_fwd(q, k, v, layout, causal)
    luts._orders[key] = tuple(torch.arange(o.numel(), dtype=torch.int32,
                                           device=cuda_device)
                              for o in orders)
    try:
        out3, lse3 = fbs.flash_block_sparse_fwd(q, k, v, layout, causal)
    finally:
        luts._orders[key] = orders
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert [c.launches - n for c, n in zip(counters, before)] == [3, 0, 0, 0]
    for a, a2, a3 in ((out, out2, out3), (lse, lse2, lse3)):
        assert torch.equal(a, a2) and torch.equal(a, a3)
    ref_out, ref_lse = fbs.flash_block_sparse_reference(q, k, v, layout,
                                                        causal)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=2e-2, rtol=2e-2)
    for special in (fbs.MAX_FLOOR, fbs.NEG_INF):
        assert torch.equal(lse == special, ref_lse == special)
    seen = (lse > fbs.MAX_FLOOR).view(b, h, s).transpose(1, 2)
    assert not out[~seen].any()
    if name == "blk64_row_above_diagonal_causal":
        assert bool((lse.view(b, h, s)[:, :, 128:192] == fbs.MAX_FLOOR)
                    .all())


@pytest.mark.cuda
def test_bf16_b5a_raises_on_misaligned_views_and_the_scalar_entry_refuses_bf16(
        cuda_device):
    """The bf16 B5a copies q, k and v in 16-byte chunks: a misaligned
    view is refused with a ValueError naming B5a and nothing is
    launched; an aligned copy goes through.  The scalar C entry
    ``ds_flash_block_sparse_fwd`` returns cudaErrorInvalidValue (1) for
    bf16 and launches nothing."""
    layout = np.ones((1, 2, 2), np.int64)
    b, s, h, d = 1, 512, 2, 64
    g = torch.Generator().manual_seed(0)
    k, v = (torch.randn(b, s, h, d, generator=g)
            .to(cuda_device, torch.bfloat16) for _ in range(2))
    base = torch.randn(b * s * h * d + 4, generator=g).to(cuda_device,
                                                          torch.bfloat16)
    shifted = base[4:].view(b, s, h, d)        # 8 bytes past alignment
    wide = torch.randn(b, s, h, d + 4, generator=g).to(
        cuda_device, torch.bfloat16)[..., :d]  # head stride d + 4
    before = fbs.flash_block_sparse_fwd.launches
    for bad in (shifted, wide):
        for args in ((bad, k, v), (k, bad, v), (k, v, bad)):
            with pytest.raises(ValueError, match="bf16 B5a"):
                fbs.flash_block_sparse_fwd(*args, layout)
    assert fbs.flash_block_sparse_fwd.launches == before
    fbs.flash_block_sparse_fwd(shifted.clone(), k, v, layout)
    assert fbs.flash_block_sparse_fwd.launches == before + 1
    luts = fbs.device_luts(layout, cuda_device)
    out = torch.empty(b, s, h, d, device=cuda_device, dtype=torch.bfloat16)
    lse = torch.empty(b * h, s, device=cuda_device)
    strides = (ctypes.c_int64 * 9)(*k.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    fwd, _ = fbs._kernels()
    rc = fwd(1, d, k.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), luts.lut.data_ptr(), luts.cnt.data_ptr(), b, h,
             s, luts.nb, luts.layout_heads, luts.kmax, strides, 0.125, 0, s,
             0, torch.cuda.current_stream().cuda_stream)
    assert rc == 1


@pytest.mark.cuda
def test_bf16_b5b_and_b6a_raise_on_misaligned_views(cuda_device):
    """The bf16 B5b and B6a copy their inputs in 16-byte chunks: a view
    off 16-byte alignment, or with a head stride that is not a multiple
    of 8 elements, is refused with a ValueError naming the kernel and
    nothing is launched; aligned copies go through."""
    layout = np.ones((1, 2, 2), np.int64)
    b, s, h, d = 1, 512, 2, 64
    g = torch.Generator().manual_seed(0)
    k, v, dout = (torch.randn(b, s, h, d, generator=g)
                  .to(cuda_device, torch.bfloat16) for _ in range(3))
    base = torch.randn(b * s * h * d + 4, generator=g).to(cuda_device,
                                                          torch.bfloat16)
    shifted = base[4:].view(b, s, h, d)        # 8 bytes past alignment
    wide = torch.randn(b, s, h, d + 4, generator=g).to(
        cuda_device, torch.bfloat16)[..., :d]  # head stride d + 4
    counters = (fbs.flash_block_sparse_bwd, fbs.flash_block_sparse_agg_fwd,
                fbs.flash_block_sparse_agg_bwd_dq,
                fbs.flash_block_sparse_agg_bwd_dkv)
    for bad in (shifted, wide):
        out, lse = fbs.flash_block_sparse_fwd(bad.clone(), k, v, layout)
        before = [c.launches for c in counters]
        for args in ((bad, k, v, dout), (k, bad, v, dout), (k, v, bad, dout),
                     (k, v, dout, bad)):
            with pytest.raises(ValueError, match="bf16 B5b"):
                fbs.flash_block_sparse_bwd(*args[:3], out, lse, args[3],
                                           layout)
        for args in ((bad, k, v), (k, bad, v), (k, v, bad)):
            with pytest.raises(ValueError, match="bf16 B6a"):
                fbs.flash_block_sparse_agg_fwd(*args, layout, 2)
        assert [c.launches for c in counters] == before
        fbs.flash_block_sparse_bwd(bad.clone(), k, v, out, lse, dout, layout)
        fbs.flash_block_sparse_agg_fwd(bad.clone(), k, v, layout, 2)
        assert [c.launches - n for c, n in zip(counters, before)] == \
            [1, 1, 0, 0]


@pytest.mark.cuda
def test_block_sparse_wrappers_raise_on_what_the_kernels_do_not_take(
        cuda_device):
    layout = np.ones((1, 4, 4), np.int64)
    q = torch.zeros(1, 64, 2, 32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        fbs.flash_block_sparse_fwd(q, q, q, layout)
    q = torch.zeros(1, 64, 2, 64, device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError, match="float64"):
        fbs.flash_block_sparse_fwd(q, q, q, layout)
    q = torch.zeros(1, 64, 2, 64, device=cuda_device, dtype=torch.float16)
    before = fbs.flash_block_sparse_fwd.fp16.launches
    fbs.flash_block_sparse_fwd(q, q, q, layout)
    assert fbs.flash_block_sparse_fwd.fp16.launches == before + 1
    q = torch.zeros(1, 64, 2, 64, device=cuda_device)
    for G in (3, 0):              # does not divide the 4 blocks, or < 1
        with pytest.raises(ValueError, match="aggregation factor"):
            fbs.flash_block_sparse_agg_fwd(q, q, q, layout, G)
    counters = (fbs.flash_block_sparse_fwd, fbs.flash_block_sparse_agg_fwd)
    for q_agg, G in ((2, 2), ("auto", 4)):   # blk 16: the JAX package
        before = [c.launches for c in counters]   # aggregates
        fbs.flash_block_sparse_attention(q, q, q, layout, q_agg=q_agg)
        assert [c.launches - b for c, b in zip(counters, before)] == [0, 1]


@pytest.mark.cuda
def test_sparse_layer_on_the_card_launches_or_raises(cuda_device,
                                                     monkeypatch):
    """The layer's sparse core on CUDA tensors: at a layout block where
    the JAX package runs its work-list kernels (256 rows) it launches
    B5a, where it runs super-tiles (32 rows) B6a, and it takes the gather
    path only when ``DS_SPARSE_FLASH=never`` asks for it; all three
    agree."""
    from deepspeed_tpu_torch.models.layers import TransformerLayer

    monkeypatch.delenv("DS_SPARSE_FLASH", raising=False)
    q = torch.randn(1, 512, 2, 64, device=cuda_device)

    def core(block):
        layer = TransformerLayer(128, 2, causal=True, attn_impl="sparse",
                                 sparsity_config=FixedSparsityConfig(
                                     num_heads=2, block=block,
                                     num_local_blocks=2,
                                     attention="unidirectional"))
        return layer._sparse_attention(q, q, q, None, None, None, True)

    before = fbs.flash_block_sparse_fwd.launches
    before_agg = fbs.flash_block_sparse_agg_fwd.launches
    out = core(256)
    assert fbs.flash_block_sparse_fwd.launches == before + 1
    out32 = core(32)
    assert fbs.flash_block_sparse_agg_fwd.launches == before_agg + 1
    monkeypatch.setenv("DS_SPARSE_FLASH", "never")
    gathered = core(256)
    gathered32 = core(32)
    assert fbs.flash_block_sparse_fwd.launches == before + 1
    assert fbs.flash_block_sparse_agg_fwd.launches == before_agg + 1
    assert float((gathered - out).abs().max()) < 1e-4
    assert float((gathered32 - out32).abs().max()) < 1e-4


@pytest.mark.cuda
def test_sparse_train_batch_launches_b5_and_never_syncs(cuda_device):
    """A sparse GPT-2 ``train_batch`` on the card: one B5a and one B5b
    launch per layer and micro-batch, no dense flash launch, and, after
    the warm-up step has built the look-up tables, no synchronizing call
    and no new table."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    config = GPT2Config(
        vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
        max_position_embeddings=512, attn_impl="sparse",
        sparsity_config=FixedSparsityConfig(
            num_heads=2, block=256, num_local_blocks=2,
            attention="unidirectional"))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(config), model_parameters=random_params(config, 0),
        config={"train_batch_size": 4, "gradient_accumulation_steps": 2,
                "steps_per_print": 10 ** 9, "gradient_clipping": 1.0,
                "optimizer": {"type": "Lamb", "params": {"lr": 1e-3}},
                "bf16": {"enabled": True}}, device=cuda_device)
    rng = np.random.RandomState(0)
    it = iter([{"input_ids": rng.randint(0, 512, size=(2, 512))}
               for _ in range(6)])
    first = float(engine.train_batch(it))   # warm-up: kernels, tables
    torch.cuda.synchronize()
    counters = (fbs.flash_block_sparse_fwd, fbs.flash_block_sparse_bwd,
                fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_fused)
    before = [c.launches for c in counters]
    tables = len(fbs._lut_cache)
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            engine.train_batch(it)
            loss = engine.train_batch(it)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
    finally:
        torch.cuda.set_sync_debug_mode(previous)
    assert syncs == 0
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [8, 8, 0, 0, 0, 0]          # 2 steps x 2 micro-batches x 2 layers
    assert len(fbs._lut_cache) == tables
    assert np.isfinite(first) and np.isfinite(float(loss))


def remat_counters():
    return (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
            fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_fused,
            fa.in_kernel_dropout, fa.draw_keep_bits)


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [128, 512], ids=["b3", "b2"])
def test_remat_recomputes_b1_and_is_bitwise_the_run_without(cuda_device,
                                                            seq):
    """GPT-2 in bf16 with dropout 0.1 through the ``activation_checkpointing``
    block: each layer's B1 and B4's draw launch twice a step, in the
    forward and in the recompute, and its backward once, drawing
    nothing; the losses and the master equal the run without remat bit
    for bit."""
    config = dict(vocab_size=512, hidden_size=128, num_layers=2,
                  num_heads=2, max_position_embeddings=512)
    ds = {"train_batch_size": 2, "steps_per_print": 10 ** 9,
          "optimizer": {"type": "Lamb", "params": {"lr": 1e-3}},
          "bf16": {"enabled": True}}
    rng = np.random.RandomState(0)
    batches = [{"input_ids": rng.randint(0, 512, size=(2, seq))}
               for _ in range(3)]
    runs = []
    for extra in ({}, {"activation_checkpointing": {}}):
        cfg = GPT2Config(**config)
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=GPT2LMHead(cfg), model_parameters=random_params(cfg, 0),
            config=dict(ds, **extra), device=cuda_device)
        torch.cuda.synchronize()
        before = [c.launches for c in remat_counters()]
        losses = torch.stack([engine.train_batch(iter([b]))
                              for b in batches])
        torch.cuda.synchronize()
        runs.append((losses, engine.master.clone(),
                     [c.launches - n for c, n in zip(remat_counters(),
                                                     before)]))
    fused = fa.use_fused_backward(64, seq, seq, torch.bfloat16)
    n = 2 * 3    # layers x steps
    bwd = [0, 0, n] if fused else [n, n, 0]
    assert runs[0][2] == [n] + bwd + [n * (1 + (1 if fused else 2)), n]
    assert runs[1][2] == [2 * n] + bwd + [n * (2 + (1 if fused else 2)),
                                          2 * n]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("cpu_checkpointing", [False, True],
                         ids=["remat", "remat_cpu"])
def test_remat_and_pld_train_batch_never_syncs(cuda_device,
                                               cpu_checkpointing):
    """BERT under remat and Progressive Layer Drop: θ goes to the card
    without a sync and the keep draws stay on it, so ``train_batch``
    makes no synchronizing call between prints."""
    from deepspeed_tpu_torch.models.bert import (BertConfig,
                                                 BertForPreTraining)
    from deepspeed_tpu_torch.models.bert import random_params as bert_params

    cfg = BertConfig(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=2, max_predictions_per_seq=20)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=BertForPreTraining(cfg), model_parameters=bert_params(cfg, 0),
        config={"train_batch_size": 4, "steps_per_print": 10 ** 9,
                "optimizer": {"type": "Lamb", "params": {"lr": 1e-3}},
                "bf16": {"enabled": True},
                "activation_checkpointing": {
                    "cpu_checkpointing": cpu_checkpointing},
                "progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                           "gamma": 0.1}},
        device=cuda_device)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 512, size=(4, 128))
    labels = np.where(rng.rand(4, 128) < 0.15, ids, -100)
    batch = {"input_ids": ids, "attention_mask": np.ones((4, 128), np.int64),
             "masked_lm_labels": labels,
             "next_sentence_labels": rng.randint(0, 2, size=(4,))}
    engine.train_batch(iter([batch]))   # warm-up
    torch.cuda.synchronize()
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            losses = [engine.train_batch(iter([batch])) for _ in range(3)]
        syncs = [str(w.message) for w in caught
                 if "synchroniz" in str(w.message)]
    finally:
        torch.cuda.set_sync_debug_mode(previous)
    assert syncs == []
    assert engine.progressive_layer_drop.get_theta() < 1.0
    assert all(np.isfinite(float(x)) for x in losses)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("fused", [True, False], ids=["b3", "b2"])
@pytest.mark.parametrize("lengths", [(40, 100), (64, 65), (63, 1),
                                     (20, 33)],
                         ids=["40-100", "64-65", "63-1", "20-33"])
def test_prefix_key_masks_match_plain(cuda_device, dtype, fused, lengths):
    """Fine-tuning batches pad each row from its own length, so whole
    64-key tiles of a row that sees other keys are masked: B1 and B3 (or
    B2a+B2b) against their plain versions at the forward and backward
    tolerances, and dk, dv exactly 0 at every masked key."""
    g = torch.Generator().manual_seed(sum(lengths))
    b, s, h, d = len(lengths), 128, 4, 64
    q, k, v, dout = (torch.randn(b, s, h, d, generator=g)
                     .to(cuda_device, dtype) for _ in range(4))
    mask = (torch.arange(s)[None] < torch.tensor(lengths)[:, None]).float()
    mask = mask.to(cuda_device)
    out, lse = flash_attention_fwd(q, k, v, mask, False, 0.0, None)
    want_out, want_lse = flash_attention_reference(q, k, v, mask, False)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=tol, rtol=tol)
    if fused:
        grads = flash_attention_bwd_fused(q, k, v, out, lse, dout, mask,
                                          False, 0.0, None)
    else:
        grads = (flash_attention_bwd_dq(q, k, v, out, lse, dout, mask,
                                        False, 0.0, None),
                 *flash_attention_bwd_dkv(q, k, v, out, lse, dout, mask,
                                          False, 0.0, None))
    ref = flash_attention_bwd_reference(q, k, v, out, lse, dout, mask,
                                        False)
    for got, want in zip(grads, ref):
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=GRAD_TOLS[dtype],
                                   rtol=GRAD_TOLS[dtype])
    hidden = mask == 0
    assert bool((grads[1][hidden] == 0).all())
    assert bool((grads[2][hidden] == 0).all())


def offload_engine(device, zero, opt="Adam", **model_kw):
    config = GPT2Config(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, max_position_embeddings=128, **model_kw)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(config), model_parameters=random_params(config, 0),
        config={"train_batch_size": 2, "steps_per_print": 10 ** 9,
                "gradient_clipping": 1.0,
                "optimizer": {"type": opt, "params": {"lr": 1e-3}},
                "zero_optimization": zero, "bf16": {"enabled": True}},
        device=device)
    rng = np.random.RandomState(0)
    return engine, {"input_ids": rng.randint(0, 512, size=(2, 128))}


@pytest.mark.cuda
@pytest.mark.parametrize("sd", ["fp32", "bf16"])
def test_offload_host_buffers_are_pinned_and_the_stream_never_syncs(
        cuda_device, sd):
    """Under ``cpu_offload`` the master, the moments and the residuals
    are pinned host buffers; a streamed step (1 MB chunks, depth 2) makes
    no synchronizing call; and the master after 3 steps is bitwise the
    run without offload's (fp32 state)."""
    zero = {"stage": 2, "cpu_offload": True, "offload_chunk_mb": 1,
            "offload_state_dtype": {"master": sd, "momentum": sd,
                                    "variance": sd, "error_feedback": True}}
    engine, batch = offload_engine(cuda_device, zero)
    bufs = [engine.master, engine.opt_state.exp_avg,
            engine.opt_state.exp_avg_sq, *engine._qres.values()]
    assert len(bufs) == (6 if sd == "bf16" else 3)
    assert all(b.device.type == "cpu" and b.is_pinned() for b in bufs)
    assert engine.host_stream_schedule()["chunks"] > 1
    engine.train_batch(iter([batch]))
    torch.cuda.synchronize()
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            engine.train_batch(iter([batch]))
            engine.train_batch(iter([batch]))
        syncs = sum("synchroniz" in str(w.message) for w in caught)
    finally:
        torch.cuda.set_sync_debug_mode(previous)
    assert syncs == 0
    if sd == "fp32":
        base, _ = offload_engine(cuda_device, {"stage": 2})
        for _ in range(3):
            base.train_batch(iter([batch]))
        torch.cuda.synchronize()
        assert torch.equal(engine.master, base.master.cpu())


@pytest.mark.cuda
def test_ds_adam_step_on_pinned_buffers_matches_plain(cuda_device):
    """The host kernel in place on pinned buffers against its plain
    version: rtol 2e-6, atol 1e-7 (the CPU test's bound)."""
    from deepspeed_tpu_torch.ops.adam import cpu_adam

    rng = np.random.RandomState(0)
    n = 1 << 20
    p, m, g = (torch.from_numpy(rng.randn(n).astype(np.float32))
               .pin_memory() for _ in range(3))
    v = torch.from_numpy(np.abs(rng.randn(n)).astype(np.float32)) \
        .pin_memory()
    q, mq, vq = p.clone(), m.clone(), v.clone()
    bc1, bc2 = cpu_adam.bias_corrections(0.9, 0.999, 3)
    cpu_adam.ds_adam_step(p, m, v, g, 1e-3, 0.9, 0.999, 1e-8, 0.01, bc1,
                          bc2, True)
    cpu_adam.plain_adam_step(q, mq, vq, g, 1e-3, 0.9, 0.999, 1e-8, 0.01, 3)
    assert p.is_pinned()
    np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(m.numpy(), mq.numpy(), rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(v.numpy(), vq.numpy(), rtol=2e-6, atol=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("path,s", [("dq+dkv", 256), ("fused", 128)])
def test_head_ranges_draw_the_whole_calls_heads(cuda_device, dtype, path,
                                                s):
    """A tensor-parallel rank's call on heads [h0, h0 + n) of 8, with
    ``head_offset`` h0 and ``total_heads`` 8, gives BITWISE the whole
    call's out, lse, dq, dk and dv of those heads at dropout 0.1: B4
    counts the global head in B1, B2a, B2b and B3 alike (and the plain
    versions agree)."""
    b, h, d = 2, 8, 64
    q, k, v, mask = make_inputs(7, b, s, s, h, d)
    t = [torch.from_numpy(x).to(cuda_device, dtype) for x in (q, k, v)]
    m = torch.from_numpy(mask).to(cuda_device)
    dout = torch.randn(b, s, h, d, generator=torch.Generator().manual_seed(
        1)).to(cuda_device, dtype)
    seed = torch.tensor([11, -5], dtype=torch.int32, device=cuda_device)
    rate = 0.1

    def bwd(q_, k_, v_, out, lse, do, h0=0, total=None):
        bits = keep_bits_of(seed, q_, k_, path != "fused", rate, h0, total)
        if path == "fused":
            return flash_attention_bwd_fused(q_, k_, v_, out, lse, do, m,
                                             False, rate, bits)
        dq = flash_attention_bwd_dq(q_, k_, v_, out, lse, do, m, True,
                                    rate, bits)
        return (dq, *flash_attention_bwd_dkv(q_, k_, v_, out, lse, do, m,
                                             True, rate, bits))

    causal = path != "fused"
    out, lse = flash_attention_fwd(*t, m, causal, rate, seed)
    grads = bwd(*t, out, lse, dout)
    lse = lse.view(b, h, s)
    for h0, n in ((0, 4), (4, 4), (2, 2)):
        part = [x[:, :, h0:h0 + n].contiguous() for x in t]
        o, l = flash_attention_fwd(*part, m, causal, rate, seed, h0, h)
        assert torch.equal(o, out[:, :, h0:h0 + n])
        assert torch.equal(l.view(b, n, s), lse[:, h0:h0 + n])
        g = bwd(*part, o, l, dout[:, :, h0:h0 + n].contiguous(), h0, h)
        for got, want in zip(g, grads):
            assert torch.equal(got, want[:, :, h0:h0 + n])
    # the plain versions draw the same global heads
    keep = fa.drop_heads(b, 2, 2, h, cuda_device)
    whole = philox_keep_mask(seed, b * h, s, s, rate).view(b, h, s, s)
    part = philox_keep_mask(seed, b * 2, s, s, rate, keep).view(b, 2, s, s)
    assert torch.equal(part, whole[:, 2:4])


def _no_plain(*args, **kwargs):
    raise AssertionError("a plain version ran on CUDA tensors")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,causal,padded", [(4, True, False),
                                             (4, False, True),
                                             (2, True, True)],
                         ids=["n4-causal", "n4-padded", "n2-causal-padded"])
def test_ring_schedule_matches_one_flash_call(cuda_device, monkeypatch,
                                              dtype, n, causal, padded):
    """The one-process ring schedule (B1 on each (Q chunk, K/V chunk)
    pair merged by lse; B2a and B2b on each pair with the merged lse and
    Δ) against one B1 call and its B2a+B2b backward at s=512: fp32 within
    the forward's 2e-5 and the backward's 5e-4; bf16 within twice the
    one call's own error against the fp32 plain version (the ring rounds
    each pair's out and dq to bf16 before the fp32 merge), plus 1e-3.
    Launches: one B1, B2a and B2b per pair at or below the diagonal
    (n(n+1)/2 causal, n² not), no B3 and no plain version; a key chunk
    that is all padding is merged with weight 0."""
    from deepspeed_tpu_torch.ops.transformer.ring_attention import (
        ring_flash_attention_local, visible_keys)

    b, s, h, d = 2, 512, 4, 64
    q, k, v, _ = make_inputs(31, b, s, s, h, d)
    dout = np.random.RandomState(32).randn(b, s, h, d).astype(np.float32)
    kpm = np.zeros((b, s), np.float32)
    if padded:
        kpm[:, s - s // n:] = -1e9
    dev = cuda_device
    q, k, v, dout = (torch.from_numpy(x).to(dev, dtype) for x in
                     (q, k, v, dout))
    kpm = torch.from_numpy(kpm).to(dev)
    mask = visible_keys(kpm)
    monkeypatch.setattr(fa, "flash_attention_reference", _no_plain)
    monkeypatch.setattr(fa, "flash_attention_bwd_reference", _no_plain)
    counters = (flash_attention_fwd, flash_attention_bwd_dq,
                flash_attention_bwd_dkv, flash_attention_bwd_fused)
    before = [c.launches for c in counters]
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ring_flash_attention_local(*qkv, n, causal=causal,
                                     key_padding_mask=kpm)
    ring = [out.detach()] + list(torch.autograd.grad(out, qkv, dout))
    pairs = n * (n + 1) // 2 if causal else n * n
    assert [c.launches - x for c, x in zip(counters, before)] == \
        [pairs, pairs, pairs, 0]
    o1, lse1 = flash_attention_fwd(q, k, v, mask, causal)
    delta = fa._delta(o1, dout)
    one = [o1, flash_attention_bwd_dq(q, k, v, o1, lse1, dout, mask, causal,
                                      delta=delta),
           *flash_attention_bwd_dkv(q, k, v, o1, lse1, dout, mask, causal,
                                    delta=delta)]
    monkeypatch.undo()
    if dtype == torch.float32:
        for got, want, tol in zip(ring, one, (2e-5, 5e-4, 5e-4, 5e-4)):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=tol, atol=tol)
        return
    f32 = [x.float() for x in (q, k, v, dout)]
    po, plse = flash_attention_reference(*f32[:3], mask, causal)
    plain = [po, *flash_attention_bwd_reference(*f32[:3], po, plse, f32[3],
                                                mask, causal)]
    for label, got, want, ref in zip(("out", "dq", "dk", "dv"), ring, one,
                                     plain):
        ring_err = (got.float() - ref).abs().max().item()
        one_err = (want.float() - ref).abs().max().item()
        assert ring_err <= 2 * one_err + 1e-3, (label, ring_err, one_err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal,masked,rate", [(True, False, 0.1),
                                                (False, True, 0.1),
                                                (True, True, 0.0)],
                         ids=["causal-dropout", "padded-dropout",
                              "causal-padded"])
def test_gather_core_matches_one_call(cuda_device, dtype, causal, masked,
                                      rate):
    """The dense gather core of 4 seq shards in one process (B1, B4 and
    B3 or B2a+B2b at each shard's query-row offset) against one call on
    the whole sequence: B4's words of each shard are bitwise its rows of
    the whole call's (and the plain version's), out and grads within the
    ring test's tolerances (fp32) or as close to the plain version as the
    one call (bf16)."""
    from deepspeed_tpu_torch.ops.transformer import gather_attention as ga
    from deepspeed_tpu_torch.ops.transformer.ring_attention import \
        visible_keys
    n, b, s, h, d = 4, 2, 512, 4, 64
    sl = s // n
    g = torch.Generator().manual_seed(int(causal) + 2 * int(masked))
    q, k, v, dout = (torch.randn(b, s, h, d, generator=g).to(cuda_device,
                                                            dtype)
                     for _ in range(4))
    kpm = None
    if masked:
        kpm = torch.zeros(b, s)
        kpm[:, 3 * s // 4 + 5:] = -1e9
        kpm = kpm.to(cuda_device)
    seed = torch.tensor([7, -3], dtype=torch.int32, device=cuda_device)
    if rate:
        whole = fa.draw_keep_bits(seed, b, h, s, s, rate, causal)
        for r in range(n):
            kv_len = (r + 1) * sl if causal else s
            part = fa.draw_keep_bits(seed, b, h, sl, kv_len, rate, causal,
                                     q_offset=r * sl)
            rows = whole[:, r * sl:(r + 1) * sl]
            assert torch.equal(part, rows[..., :part.shape[-1]])
            assert not rows[..., part.shape[-1]:].any()
            assert torch.equal(part.cpu(), fa.philox_keep_bits(
                seed.cpu(), b * h, sl, kv_len, rate, causal=causal,
                q_offset=r * sl))
    counters = (flash_attention_fwd, fa.draw_keep_bits)
    before = [c.launches for c in counters]
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ga.gather_flash_attention_local(*qkv, n, causal, kpm, rate,
                                          seed if rate else None)
    got = [out.detach()] + list(torch.autograd.grad(out, qkv, dout))
    assert [c.launches - x for c, x in zip(counters, before)] == \
        [n, n if rate else 0]
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    one = fa.FlashAttention.apply(*qkv, visible_keys(kpm),
                                  seed if rate else None, causal, rate, 0,
                                  None)
    want = [one.detach()] + list(torch.autograd.grad(one, qkv, dout))
    if dtype == torch.float32:
        for label, x, y, tol in zip(("out", "dq", "dk", "dv"), got, want,
                                    (2e-5, 5e-4, 5e-4, 5e-4)):
            torch.testing.assert_close(x, y, rtol=tol, atol=tol,
                                       msg=lambda m: f"{label}: {m}")
        return
    for label, x, y in zip(("out", "dq", "dk", "dv"), got, want):
        # the shards' partial dk, dv are rounded to bf16 before their fp32
        # sum: within a few bf16 ulps of the one call
        err = (x.float() - y.float()).abs().max().item()
        assert err <= 3e-2 * max(1.0, y.float().abs().max().item()), \
            (label, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["fixed_uni_b5", "fixed_bi_b6",
                                  "bigbird_b6", "variable_uni_b6"])
def test_sparse_gather_core_matches_one_call(cuda_device, dtype, kind):
    """The block-sparse gather core of 4 seq shards (each its block rows
    of the whole layout at its query-row offset; B5 at G = 1, B6 at G =
    4) against one call on the whole sequence."""
    from deepspeed_tpu_torch.ops.sparse_attention import \
        VariableSparsityConfig
    from deepspeed_tpu_torch.ops.transformer import gather_attention as ga
    n, b, s, h, d, blk = 4, 1, 1024, 4, 64, 64
    if kind == "fixed_uni_b5":
        cfg, causal, q_agg = FixedSparsityConfig(
            num_heads=h, block=blk, attention="unidirectional"), True, "never"
    elif kind == "fixed_bi_b6":
        cfg, causal, q_agg = FixedSparsityConfig(num_heads=h,
                                                 block=blk), False, "auto"
    elif kind == "bigbird_b6":
        cfg, causal, q_agg = BigBirdSparsityConfig(num_heads=h,
                                                   block=blk), False, "auto"
    else:
        cfg, causal, q_agg = VariableSparsityConfig(
            num_heads=h, block=blk, attention="unidirectional"), True, "auto"
    layout = cfg.make_layout(s)
    G = ga.seq_sparse_factor(layout, s, n, q_agg)
    assert G == (1 if kind.endswith("b5") else 4)
    g = torch.Generator().manual_seed(len(kind))
    q, k, v, dout = (torch.randn(b, s, h, d, generator=g).to(cuda_device,
                                                            dtype)
                     for _ in range(4))
    names = (("flash_block_sparse_fwd", "flash_block_sparse_bwd") if G == 1
             else ("flash_block_sparse_agg_fwd",
                   "flash_block_sparse_agg_bwd_dq",
                   "flash_block_sparse_agg_bwd_dkv"))
    counters = [getattr(fbs, x) for x in names]
    before = [c.launches for c in counters]
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ga.gather_block_sparse_attention_local(*qkv, layout, n, causal,
                                                 q_agg)
    got = [out.detach()] + list(torch.autograd.grad(out, qkv, dout))
    assert [c.launches - x for c, x in zip(counters, before)] == \
        [n] * len(names)
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    one = fbs.flash_block_sparse_attention(*qkv, layout, causal, q_agg)
    want = [one.detach()] + list(torch.autograd.grad(one, qkv, dout))
    for label, x, y in zip(("out", "dq", "dk", "dv"), got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(x, y, rtol=5e-4, atol=5e-4,
                                       msg=lambda m: f"{label}: {m}")
        else:
            err = (x.float() - y.float()).abs().max().item()
            assert err <= 3e-2 * max(1.0, y.float().abs().max().item()), \
                (label, err)
