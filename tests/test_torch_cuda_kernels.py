"""The port's Hopper kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX, so it runs on a machine with PyTorch alone, without
the repo's conftest (which loads JAX):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda

Tolerances: the forward fp32 2e-5 (matmuls in full fp32, TF32 off; only
the summation order differs), bf16 2e-2 (both round P to bf16 before P·V
and the output to bf16, at different points of a different summation
order); the backward fp32 5e-4 (the flash tests' grad tolerance), bf16
1e-2 (dS and P rounded to bf16 after fp32 sums in another order).
"""

import warnings

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.ops.transformer.flash_attention import (
    flash_attention_bwd_dkv, flash_attention_bwd_dq,
    flash_attention_bwd_fused, flash_attention_bwd_reference,
    flash_attention_fwd, flash_attention_reference, philox_keep_mask)

GRAD_TOLS = {torch.float32: 5e-4, torch.bfloat16: 1e-2}


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
                                       (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("s,kv_len,d,causal", [
    (128, 128, 64, True), (300, 300, 64, True), (256, 200, 64, False),
    (200, 320, 64, True), (128, 128, 128, True)])
def test_flash_fwd_kernel_matches_plain(cuda_device, dtype, tol, s, kv_len,
                                        d, causal):
    q, k, v, mask = make_inputs(s + d, 2, s, kv_len, 4, d)
    t = [torch.from_numpy(x).to(cuda_device, dtype) for x in (q, k, v)]
    m = torch.from_numpy(mask).to(cuda_device)
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(*t, m, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    ref_out, ref_lse = flash_attention_reference(*t, m, causal=causal)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)
    assert bool((out[-1] == 0).all())


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
def test_engine_syncs_once_per_prefill_and_decode_iteration(cuda_device):
    """The serve loop's only host syncs are its token fetches: one per
    prefill and one per decode iteration (counted by CUDA sync debug
    mode, which warns at every synchronizing call)."""
    config = GPT2Config(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, max_position_embeddings=256)
    engine = InferenceEngine(
        GPT2LMHead(config), random_params(config, seed=0),
        config={"inference": {
            "kv_block_size": 16, "max_seq_len": 256,
            "prefill_buckets": [128, 256], "max_batch_slots": 4,
            "kv_blocks": 64, "token_budget": 1024, "max_new_tokens": 4}},
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


def backward_by_kernels(path, q, k, v, out, lse, dout, mask, causal, rate,
                        seed):
    if path == "b3":
        return flash_attention_bwd_fused(q, k, v, out, lse, dout, mask,
                                         causal, rate, seed)
    dq = flash_attention_bwd_dq(q, k, v, out, lse, dout, mask, causal, rate,
                                seed)
    return (dq,) + flash_attention_bwd_dkv(q, k, v, out, lse, dout, mask,
                                           causal, rate, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("path,s,kv_len,d,causal,rate", [
    ("b2", 256, 256, 64, True, 0.0), ("b2", 300, 200, 64, False, 0.0),
    ("b2", 128, 128, 128, True, 0.0), ("b2", 256, 256, 64, True, 0.1),
    ("b3", 128, 128, 64, True, 0.0), ("b3", 64, 64, 128, False, 0.1)])
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
def test_fused_backward_threshold(cuda_device):
    """B3 runs where Q, dO, K, V and the score tile fit one block's
    232,448 bytes of shared memory, as the CUDA source counts them:
    s = kv_len <= 142 at d=64, <= 94 at d=128."""
    assert fa.use_fused_backward(64, 128, 128)
    assert fa.use_fused_backward(64, 142, 142)
    assert not fa.use_fused_backward(64, 143, 143)
    assert not fa.use_fused_backward(64, 256, 256)
    assert fa.use_fused_backward(128, 94, 94)
    assert not fa.use_fused_backward(128, 95, 95)


@pytest.mark.cuda
def test_keep_mask_drawn_by_b1_equals_plain(cuda_device):
    """With q = 0 and V the identity over kv_len = head_dim keys, B1's
    output is keep · inv_keep / kv_len: its mask is the plain one."""
    q = torch.zeros(1, 512, 4, 64, device=cuda_device)
    k = torch.randn(1, 64, 4, 64, device=cuda_device)
    v = torch.eye(64, device=cuda_device)[None, :, None, :].expand(
        1, 64, 4, 64).contiguous()
    seed = torch.tensor([3, 4], dtype=torch.int32, device=cuda_device)
    out, _ = flash_attention_fwd(q, k, v, None, False, 0.3, seed)
    kept = out.permute(0, 2, 1, 3).reshape(4, 512, 64) > 0
    assert torch.equal(kept, philox_keep_mask(seed, 4, 512, 64, 0.3))


@pytest.mark.cuda
def test_train_batch_syncs_only_at_the_print_cadence(cuda_device):
    """``train_batch`` fetches nothing from the card between prints: no
    synchronizing call (CUDA sync debug mode warns at each) except the
    loss fetch of the step that prints."""
    config = GPT2Config(vocab_size=512, hidden_size=128, num_layers=2,
                        num_heads=2, max_position_embeddings=128)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(config), model_parameters=random_params(config, 0),
        config={"train_batch_size": 4, "gradient_accumulation_steps": 2,
                "steps_per_print": 3, "gradient_clipping": 1.0,
                "optimizer": {"type": "Lamb", "params": {"lr": 1e-3}},
                "bf16": {"enabled": True}}, device=cuda_device)
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
