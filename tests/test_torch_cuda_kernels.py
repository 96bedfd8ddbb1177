"""The port's Hopper kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX, so it runs on a machine with PyTorch alone, without
the repo's conftest (which loads JAX):

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda

Tolerances: fp32 2e-5 (matmuls in full fp32, TF32 off; only the
summation order differs); bf16 2e-2 (both round P to bf16 before P·V and
the output to bf16, at different points of a different summation
order).
"""

import warnings

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params
from deepspeed_tpu_torch.ops.transformer.flash_attention import (
    flash_attention_fwd, flash_attention_reference)


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
