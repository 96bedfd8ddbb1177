"""The port's flops profiler (``deepspeed_tpu_torch/profiling/flops_profiler``)
against the JAX package's (``deepspeed_tpu/profiling/flops_profiler``).

- The JAX tests of ``tests/unit/test_flops_profiler.py`` that have a
  meaning in eager PyTorch: the exact matmul count, the backward counted
  too, scope attribution, ``get_model_profile``, the engine wiring, wall
  time and MFU.  Its scan, while-loop and cond cases have no eager
  counterpart: the port counts the ops a step runs, so a loop counts
  every trip it makes and a branch the branch taken.
- Each kernel wrapper's registered count (B1-B6, through
  ``kernel_launch``) equals the profiler's count of its plain version,
  over causal, key-mask, dropout, head and query-row offsets and sparse
  layouts at G = 1 and G > 1.
- The tiny GPT-2 and BERT, forward and forward+backward, against the
  JAX package's ``count_fn_flops`` on the same config: matmul FLOPs
  equal exactly, the total within 2%.
"""

import contextlib
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models.bert import BertConfig as JBertConfig
from deepspeed_tpu.models.bert import BertForPreTrainingTPU
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadTPU
from deepspeed_tpu.parallel import make_mesh as jmake_mesh
from deepspeed_tpu.profiling.flops_profiler import count_fn_flops as jcount
from deepspeed_tpu.profiling.flops_profiler import params_count as jparams
from deepspeed_tpu.profiling.flops_profiler import profiler as jprof
from deepspeed_tpu_torch.models.bert import BertConfig, BertForPreTraining
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
from deepspeed_tpu_torch.ops.sparse_attention import \
    flash_block_sparse as fbs
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.profiling import utilization
from deepspeed_tpu_torch.profiling import wall_breakdown
from deepspeed_tpu_torch.profiling.flops_profiler import (
    COMPOSITE, FlopCounter, FlopsProfile, count_fn_flops, get_model_profile,
    kernel_launch, named_scope, params_count)
from deepspeed_tpu_torch.utils.params import params_from_numpy

from .torch_simple_model import SimpleModel, random_batches

HIDDEN = 16
GPT2_TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                 max_position_embeddings=64, embd_dropout=0.0,
                 attn_dropout=0.0, resid_dropout=0.0)
BERT_TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=64,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
# the total's tolerance against the JAX count; the measured gaps are in
# MODEL_GAPS
TOTAL_RTOL = 0.02


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def base_config(**overrides):
    cfg = {"train_batch_size": 2, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    cfg.update(overrides)
    return cfg


# ------------------------------------------------------------ the rules
def test_matmul_exact_count():
    B, K, N = 8, 32, 64
    flops, _ = count_fn_flops(lambda a, b: a @ b, torch.ones(B, K),
                              torch.ones(K, N))
    assert flops == 2 * B * K * N
    assert flops == jcount(lambda a, b: a @ b, jnp.ones((B, K)),
                           jnp.ones((K, N)))[0]


@pytest.mark.parametrize("op", ["linear", "einsum", "bmm", "addmm"])
def test_the_matmul_under_each_aten_form(op):
    """``linear`` (addmm: the product and the bias add, as dense's
    ``x @ W + b``), ``einsum`` and ``bmm`` count ``2·batch·m·n·k``."""
    b, m, k, n = 3, 4, 8, 16
    x, w, bias = torch.ones(b, m, k), torch.ones(k, n), torch.ones(n)
    fns = {"linear": (lambda: torch.nn.functional.linear(x[0], w.T, bias),
                      2 * m * k * n + m * n),
           "einsum": (lambda: torch.einsum("bmk,kn->bmn", x, w),
                      2 * b * m * k * n),
           "bmm": (lambda: torch.bmm(x, w.expand(b, k, n)),
                   2 * b * m * k * n),
           "addmm": (lambda: torch.addmm(bias, x[0], w),
                     2 * m * k * n + m * n)}
    fn, want = fns[op]
    assert count_fn_flops(fn)[0] == want


def test_conv_flops_exact_count():
    """2 · output elements · kernel taps per output channel, as the JAX
    profiler counts ``conv_general_dilated``."""
    B, C, H, W, O, K = 2, 3, 8, 8, 4, 3
    flops, _ = count_fn_flops(
        lambda x, w: torch.nn.functional.conv2d(x, w, padding=1),
        torch.ones(B, C, H, W), torch.ones(O, C, K, K))
    assert flops == 2 * (B * O * H * W) * (C * K * K)
    import jax.lax as lax

    jflops, _ = jcount(lambda x, w: lax.conv_general_dilated(
        x, w, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW")),
        jnp.ones((B, C, H, W)), jnp.ones((O, C, K, K)))
    assert flops == jflops


def test_grad_counts_backward_too():
    """Training FLOPs come from the backward the profiler sees run, not a
    3x heuristic: d(xW) takes two more matmuls (dx = gWᵀ, dW = xᵀg)."""
    B, K, N = 4, 8, 16
    x = torch.ones(B, K, requires_grad=True)
    w = torch.ones(K, N, requires_grad=True)

    def loss():
        return (x @ w).sum()

    fwd, _ = count_fn_flops(loss)
    both, _ = count_fn_flops(lambda: loss().backward())
    assert both >= fwd + 2 * B * K * N - 2 * B * N
    assert both - fwd == 2 * 2 * B * K * N


@pytest.mark.parametrize("name,fn,shape", [
    ("_softmax", lambda x: torch.softmax(x, -1), (8, 32)),
    ("_log_softmax", lambda x: torch.log_softmax(x, -1), (8, 32)),
    ("logsumexp", lambda x: torch.logsumexp(x, -1), (8, 32)),
    ("mean", lambda x: x.mean(-1), (8, 32)),
    ("gelu", lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
     (8, 32)),
    ("native_layer_norm",
     lambda x: torch.nn.functional.layer_norm(x, (32,)), (8, 32)),
])
def test_composite_ops_count_the_jax_decomposition(name, fn, shape):
    """A composite aten op counts ``a·n + b·rows``: the count of the JAX
    function it stands for on the same input (``COMPOSITE``)."""
    jfns = {"_softmax": lambda x: jax.nn.softmax(x, -1),
            "_log_softmax": lambda x: jax.nn.log_softmax(x, -1),
            "logsumexp": lambda x: jax.scipy.special.logsumexp(x, -1),
            "mean": lambda x: jnp.mean(x, -1),
            "gelu": lambda x: jax.nn.gelu(x, approximate=True),
            "native_layer_norm": None}
    counter = FlopCounter()
    with counter.count():
        fn(torch.ones(shape))
    a, b = COMPOSITE[name]
    assert counter.by_op == {name: a * shape[0] * shape[1] + b * shape[0]}
    if jfns[name] is not None:
        assert counter.flops == jcount(jfns[name], jnp.ones(shape))[0]
    else:
        from deepspeed_tpu.models.layers import layer_norm

        p = {"scale": jnp.ones(shape[-1]), "bias": jnp.zeros(shape[-1])}
        assert counter.flops == jcount(lambda x: layer_norm(p, x),
                                       jnp.ones(shape))[0]


def test_named_scope_attribution():
    K = 32
    w1, w2 = torch.ones(K, K), torch.ones(K, 2 * K)

    def fn(x):
        with named_scope("small"):
            a = x @ w1
        with named_scope("big"):
            b = a @ w2
        return b.sum()

    flops, by_scope = count_fn_flops(fn, torch.ones(4, K))
    assert by_scope["small"] == 2 * 4 * K * K
    assert by_scope["big"] == 2 * 4 * K * 2 * K
    assert flops == sum(by_scope.values())


def test_module_paths_attribute_the_backward_too():
    """An ``nn.Module`` submodule's forward and its backward count under
    its path: the backward op reads the scope its autograd node was made
    in."""
    model = torch.nn.Sequential(torch.nn.Linear(8, 16, bias=False),
                                torch.nn.Tanh(),
                                torch.nn.Linear(16, 4, bias=False))
    x = torch.ones(2, 8)
    counter = FlopCounter()
    with counter.count(module=model):
        model(x).sum().backward()
    scopes = dict(counter.by_scope)
    # layer 0: forward 2·2·8·16, backward dW only (x needs no grad)
    assert scopes["0"] == 2 * 2 * 8 * 16 * 2
    # layer 2: forward, dW and dx
    assert scopes["2"] == 2 * 2 * 16 * 4 * 3
    # tanh forward n and tanh_backward 3n (COMPOSITE)
    assert scopes["1"] == 2 * 16 * (1 + 3)


def test_get_model_profile_simple_model():
    model = SimpleModel(HIDDEN, nlayers=2)
    batch = tuple(torch.from_numpy(a) for a in
                  random_batches(1, 8, HIDDEN, seed=0)[0])
    params = model.init(0)
    flops, macs, n_params = get_model_profile(
        model=model, batch=batch, params=params, print_profile=False,
        device="cpu")
    assert n_params == params_count(params) == 2 * (HIDDEN * HIDDEN + HIDDEN)
    assert flops > 0 and macs == flops // 2
    ftrain, _, _ = get_model_profile(model=model, batch=batch, params=params,
                                     train=True, print_profile=False,
                                     device="cpu")
    assert ftrain > flops
    strings = get_model_profile(model=model, batch=batch, params=params,
                                as_string=True, print_profile=False,
                                device="cpu")
    assert strings[0].endswith("FLOPs") and strings[2].endswith("params")


def test_get_model_profile_of_a_function():
    x, w = torch.ones(4, 8), torch.ones(8, 8)
    flops, macs, n = get_model_profile(fn=lambda a, b: b @ a, args=(w, x),
                                       print_profile=False)
    assert flops == 2 * 4 * 8 * 8 and macs == flops // 2 and n == 64


# ------------------------------------------------------------ utilization
def test_utilization_table_is_the_h100s():
    """One table, the H100 data sheet's, and no TPU entry: the SXM card
    ("NVIDIA H100 80GB HBM3") at 989 dense bf16 TFLOP/s and 3.35 TB/s,
    what chip_smoke.py quotes; unknown names get the SXM row."""
    sxm = utilization.chip_specs("NVIDIA H100 80GB HBM3")
    assert sxm["peak_tflops"] == 989.0 and sxm["hbm_gbps"] == 3350.0
    assert sxm["peak_tflops_fp32"] == 67.0
    assert utilization.chip_specs("NVIDIA H100 PCIe")["peak_tflops"] == 756.0
    assert utilization.chip_specs("cpu")["peak_tflops"] == \
        utilization.DEFAULT_PEAK_TFLOPS == 989.0
    assert not any(k.startswith("v") for k in utilization.PEAK_TFLOPS)
    assert utilization.chip_peak_tflops("NVIDIA H100 80GB HBM3",
                                        torch.float32) == 67.0
    assert utilization.model_flops_utilization(10.0, 1e12, 100.0) == 0.1


def test_flops_profile_wall_and_mfu():
    prof = FlopsProfile(flops=2 * 10 ** 12, macs=10 ** 12, params=1000,
                        wall_ms=100.0, device="NVIDIA H100 80GB HBM3")
    assert prof.achieved_tflops() == 20.0
    assert prof.mfu() == 20.0 / 989.0
    assert FlopsProfile(1, 0, 1).achieved_tflops() is None
    assert FlopsProfile(1, 0, 1).mfu() is None


# ------------------------------------------------------------ the kernels
@contextlib.contextmanager
def meta_card(monkeypatch):
    """The kernel wrappers' CUDA branch on ``meta`` tensors: every launch
    stubbed to return 0, so the wrapper runs its checks, its launch call
    and its ``kernel_launch`` registration without a card."""
    def fake(*a):
        return 0

    monkeypatch.setattr(fa, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(fa, "_fwd_kernel", lambda: fake)
    monkeypatch.setattr(fa, "_bwd_kernel", lambda: fake)
    monkeypatch.setattr(fa, "fused_backward_fits", lambda *a: True)
    monkeypatch.setattr(fbs, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(fbs, "_kernels", lambda: (fake, fake))
    monkeypatch.setattr(fbs, "_agg_kernels", lambda dtype: (fake,) * 3)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=0))
    yield


def registered(name, fn):
    counter = FlopCounter()
    with counter.count():
        fn()
    return counter.kernels[name]["flops"]


def profiled(fn):
    counter = FlopCounter()
    with counter.count():
        fn()
    return counter.flops


def meta(*ts):
    return [None if t is None else t.to("meta") for t in ts]


# (label, causal, key mask, dropout, head offset of total heads, q_offset)
DENSE_CASES = [
    ("plain", False, False, 0.0, (0, None), 0),
    ("causal", True, False, 0.0, (0, None), 0),
    ("key_mask", False, True, 0.0, (0, None), 0),
    ("dropout", False, False, 0.1, (0, None), 0),
    ("causal_dropout_mask", True, True, 0.1, (0, None), 0),
    ("head_offset", True, False, 0.1, (2, 6), 0),
    ("query_rows", True, False, 0.1, (0, None), 16),
]


def dense_inputs(masked, rate, causal, heads, q_offset):
    b, s, h, d = 2, 16, 2, 16
    kv_len = s + q_offset
    g = torch.Generator().manual_seed(7)
    q, dout = (torch.randn(b, s, h, d, generator=g) for _ in range(2))
    k, v = (torch.randn(b, kv_len, h, d, generator=g) for _ in range(2))
    mask = None
    if masked:
        mask = torch.ones(b, kv_len)
        mask[1, kv_len // 2:] = 0
    seed = torch.tensor([3, 5], dtype=torch.int32)
    off, total = heads
    bits = (fa.draw_keep_bits(seed, b, h, s, kv_len, rate, causal, off,
                              total, q_offset) if rate else None)
    return q, k, v, dout, mask, seed, bits


@pytest.mark.parametrize("label,causal,masked,rate,heads,q_offset",
                         [c for c in DENSE_CASES if c[3]],
                         ids=[c[0] for c in DENSE_CASES if c[3]])
def test_keep_bits_count_equals_plain(label, causal, masked, rate, heads,
                                      q_offset):
    """B4 registers (its wrapper's own ``kernel_launch`` call, with its
    plain version) what the profiler counts for the draw on CPU tensors.
    Its CUDA branch needs a CUDA seed: the card's phase 43 runs the
    wrapper itself."""
    q, k, v, dout, mask, seed, bits = dense_inputs(masked, rate, causal,
                                                   heads, q_offset)
    b, s, h, _ = q.shape
    kv_len = k.shape[1]
    off, total = heads
    counter = FlopCounter()
    with counter.count():
        kernel_launch("B4", fa._keep_plain, seed, b, h, s, kv_len, rate,
                      causal, off, total or h, q_offset)
    assert counter.kernels["B4"]["flops"] == profiled(
        lambda: fa.draw_keep_bits(seed, b, h, s, kv_len, rate, causal, off,
                                  total, q_offset)) > 0


@pytest.mark.parametrize("kernel", ["B1", "B2a", "B2b", "B3"])
@pytest.mark.parametrize("label,causal,masked,rate,heads,q_offset",
                         DENSE_CASES, ids=[c[0] for c in DENSE_CASES])
def test_dense_kernel_counts_equal_plain(monkeypatch, kernel, label, causal,
                                         masked, rate, heads, q_offset):
    """B1, B2a, B2b and B3 register, through their wrappers' CUDA branch
    (on meta tensors, the launch stubbed), exactly what the profiler
    counts for their plain versions on the same CPU tensors."""
    q, k, v, dout, mask, seed, bits = dense_inputs(masked, rate, causal,
                                                   heads, q_offset)
    out, lse = fa._fwd_plain(q, k, v, mask, causal, rate, bits, q_offset)
    plain = {
        "B1": lambda: fa._fwd_plain(q, k, v, mask, causal, rate, bits,
                                    q_offset),
        "B2a": lambda: fa._bwd_plain(q, k, v, out, lse, dout, mask, causal,
                                     rate, bits, q_offset, "dq"),
        "B2b": lambda: fa._bwd_plain(q, k, v, out, lse, dout, mask, causal,
                                     rate, bits, q_offset, "dkv"),
        "B3": lambda: fa._bwd_plain(q, k, v, out, lse, dout, mask, causal,
                                    rate, bits, q_offset, "fused")}[kernel]
    mq, mk, mv, mo, ml, md, mm, mb = meta(q, k, v, out, lse, dout, mask,
                                          bits)
    wrappers = {
        "B1": lambda: fa.flash_attention_fwd(mq, mk, mv, mm, causal, rate,
                                             keep_bits=mb, q_offset=q_offset),
        "B2a": lambda: fa.flash_attention_bwd_dq(
            mq, mk, mv, mo, ml, md, mm, causal, rate, mb, q_offset=q_offset),
        "B2b": lambda: fa.flash_attention_bwd_dkv(
            mq, mk, mv, mo, ml, md, mm, causal, rate, mb, q_offset=q_offset),
        "B3": lambda: fa.flash_attention_bwd_fused(
            mq, mk, mv, mo, ml, md, mm, causal, rate, mb,
            q_offset=q_offset)}
    with meta_card(monkeypatch):
        got = registered(kernel, wrappers[kernel])
    assert got == profiled(plain) > 0


# (label, layout heads, block, causal, G, q_offset blocks)
SPARSE_CASES = [
    ("causal_g1", 2, 8, True, 1, 0),
    ("bidirectional_g1", 1, 8, False, 1, 0),
    ("causal_g2", 2, 8, True, 2, 0),
    ("bidirectional_g4", 2, 4, False, 4, 0),
    ("query_rows_g2", 2, 8, True, 2, 2),
]


@pytest.mark.parametrize("kernel", ["B5a", "B5b", "B6a", "B6b", "B6c"])
@pytest.mark.parametrize("label,lheads,blk,causal,G,qblocks", SPARSE_CASES,
                         ids=[c[0] for c in SPARSE_CASES])
def test_sparse_kernel_counts_equal_plain(monkeypatch, kernel, label,
                                          lheads, blk, causal, G, qblocks):
    """B5a/B5b (G = 1) and B6a/B6b/B6c (G > 1; at G = 1 too) register,
    through their wrappers' CUDA branch, exactly the profiler's count of
    their plain versions, over shared and per-head layouts and a
    sequence-parallel rank's query rows (``q_offset``)."""
    h, d, b = 2, 16, 2
    cfg = FixedSparsityConfig(num_heads=h, block=blk, num_local_blocks=2,
                              different_layout_per_head=lheads > 1)
    s_all = 64
    layout = cfg.make_layout(s_all)
    q_offset = qblocks * blk
    rows = s_all - q_offset
    layout = np.ascontiguousarray(np.asarray(layout)[:, qblocks:])
    g = torch.Generator().manual_seed(11)
    q, dout = (torch.randn(b, rows, h, d, generator=g) for _ in range(2))
    k, v = (torch.randn(b, s_all, h, d, generator=g) for _ in range(2))
    ref = fbs.flash_block_sparse_agg_reference if G > 1 \
        else fbs.flash_block_sparse_reference
    out, lse = (ref(q, k, v, layout, G, causal, q_offset) if G > 1
                else ref(q, k, v, layout, causal, q_offset))
    plain = {
        "B5a": lambda: fbs.flash_block_sparse_reference(q, k, v, layout,
                                                        causal, q_offset),
        "B5b": lambda: fbs.flash_block_sparse_bwd_reference(
            q, k, v, out, lse, dout, layout, causal, q_offset),
        "B6a": lambda: fbs.flash_block_sparse_agg_reference(
            q, k, v, layout, G, causal, q_offset),
        "B6b": lambda: fbs.flash_block_sparse_agg_bwd_dq_reference(
            q, k, v, out, lse, dout, layout, G, causal, q_offset),
        "B6c": lambda: fbs.flash_block_sparse_agg_bwd_dkv_reference(
            q, k, v, out, lse, dout, layout, G, causal, q_offset)}[kernel]
    mq, mk, mv, mo, ml, md = meta(q, k, v, out, lse, dout)
    wrappers = {
        "B5a": lambda: fbs.flash_block_sparse_fwd(mq, mk, mv, layout, causal,
                                                  q_offset),
        "B5b": lambda: fbs.flash_block_sparse_bwd(mq, mk, mv, mo, ml, md,
                                                  layout, causal, q_offset),
        "B6a": lambda: fbs.flash_block_sparse_agg_fwd(mq, mk, mv, layout, G,
                                                      causal, q_offset),
        "B6b": lambda: fbs.flash_block_sparse_agg_bwd_dq(
            mq, mk, mv, mo, ml, md, layout, G, causal, q_offset=q_offset),
        "B6c": lambda: fbs.flash_block_sparse_agg_bwd_dkv(
            mq, mk, mv, mo, ml, md, layout, G, causal, q_offset=q_offset)}
    with meta_card(monkeypatch):
        got = registered(kernel, wrappers[kernel])
    assert got == profiled(plain) > 0


def test_kernel_launch_counts_nothing_without_a_profiler():
    called = []
    assert kernel_launch("B1", lambda: called.append(1)) is None
    assert not called


def test_split_backward_plain_versions_are_bitwise_the_whole():
    """B2a's and B2b's plain versions (each from its own score pass, as
    the kernels recompute P and dP) give the whole plain backward's dq and
    (dk, dv) bitwise; so do B6b's and B6c's."""
    g = torch.Generator().manual_seed(3)
    q, k, v, dout = (torch.randn(2, 32, 2, 16, generator=g)
                     for _ in range(4))
    out, lse = fa.flash_attention_reference(q, k, v, causal=True)
    whole = fa.flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                             causal=True)
    assert torch.equal(fa.flash_attention_bwd_dq_reference(
        q, k, v, out, lse, dout, causal=True), whole[0])
    for a, b in zip(fa.flash_attention_bwd_dkv_reference(
            q, k, v, out, lse, dout, causal=True), whole[1:]):
        assert torch.equal(a, b)
    layout = FixedSparsityConfig(num_heads=2, block=8).make_layout(32)
    out, lse = fbs.flash_block_sparse_agg_reference(q, k, v, layout, 2, True)
    whole = fbs.flash_block_sparse_agg_bwd_reference(q, k, v, out, lse, dout,
                                                     layout, 2, True)
    assert torch.equal(fbs.flash_block_sparse_agg_bwd_dq_reference(
        q, k, v, out, lse, dout, layout, 2, True), whole[0])
    for a, b in zip(fbs.flash_block_sparse_agg_bwd_dkv_reference(
            q, k, v, out, lse, dout, layout, 2, True), whole[1:]):
        assert torch.equal(a, b)


# ---------------------------------------------- the models against JAX
def jax_split(fn, *args):
    """``(matmul FLOPs, total FLOPs, primitives)`` of the JAX count: the
    JAX walk with its dot_general terms summed apart."""
    closed = jax.make_jaxpr(fn)(*args)
    mm, prims = [0], set()

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            prims.add(eqn.primitive.name)
            inner = None
            for key in ("jaxpr", "call_jaxpr"):
                if key in eqn.params:
                    inner = getattr(eqn.params[key], "jaxpr",
                                    eqn.params[key])
                    break
            if inner is not None:
                walk(inner)
            elif eqn.primitive.name == "dot_general":
                mm[0] += jprof._dot_general_flops(eqn)

    walk(closed.jaxpr)
    return mm[0], jcount(fn, *args)[0], prims


def gpt2_case():
    jm = GPT2LMHeadTPU(JGPT2Config(**GPT2_TINY))
    tm = GPT2LMHead(GPT2Config(**GPT2_TINY))
    ids = np.random.default_rng(0).integers(0, 256, (2, 16))
    return jm, tm, {"input_ids": ids}


def bert_case():
    jm = BertForPreTrainingTPU(JBertConfig(**BERT_TINY))
    tm = BertForPreTraining(BertConfig(**BERT_TINY))
    rng = np.random.default_rng(1)
    b, s = 2, 16
    labels = np.where(rng.random((b, s)) < 0.2,
                      rng.integers(0, 128, (b, s)), -100)
    mask = np.ones((b, s), np.int64)
    mask[1, 12:] = 0
    batch = {"input_ids": rng.integers(0, 128, (b, s)),
             "token_type_ids": (np.arange(s)[None] >= s // 2)
             .repeat(b, 0).astype(np.int64),
             "attention_mask": mask, "masked_lm_labels": labels,
             "next_sentence_labels": np.array([0, 1])}
    return jm, tm, batch


# measured relative gaps (port − JAX) / JAX of the total, by model and
# pass: the port counts more, by three aten rules where JAX's primitives
# count less: a tensor used twice gets its gradients summed by aten.add
# in the backward (JAX's add_any counts nothing), x.square() is aten.pow
# (jnp.square counts nothing), and mean's backward divides every element
# (JAX divides the reduced row before broadcasting it)
MODEL_GAPS = {("gpt2", False): 0.0011, ("gpt2", True): 0.0066,
              ("bert", False): 0.0016, ("bert", True): 0.0069}


@pytest.mark.parametrize("train", [False, True], ids=["fwd", "fwd_bwd"])
@pytest.mark.parametrize("kind", ["gpt2", "bert"])
def test_model_counts_match_the_jax_package(kind, train):
    """Matmul FLOPs equal exactly; the total within 2% (the measured gap
    in ``MODEL_GAPS``, to 1e-4).  No ``pallas_call`` is in the JAX
    program at these sizes (the CPU takes its dense attention), so the
    attention's count needs no holding apart here."""
    jm, tm, batch = gpt2_case() if kind == "gpt2" else bert_case()
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    jbatch = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}

    def jfwd(p):
        return jm.apply(p, jbatch, rng=None, train=True)

    jfn = (jax.grad(lambda p: jfwd(p).astype(jnp.float32).sum()) if train
           else jfwd)
    jmm, jtotal, prims = jax_split(jfn, params)
    assert "pallas_call" not in prims

    tparams = params_from_numpy(params, "cpu")
    if train:
        for leaf in jax.tree_util.tree_leaves(tparams):
            if leaf.is_floating_point():
                leaf.requires_grad_(True)
    tbatch = {k: torch.from_numpy(np.asarray(v)).long()
              for k, v in batch.items()}
    counter = FlopCounter()
    with counter.count():
        with torch.set_grad_enabled(train):
            loss = tm.apply(tparams, tbatch, rng=None, train=True)
            if train:
                loss.float().sum().backward()
    assert counter.matmul_flops == jmm
    gap = (counter.flops - jtotal) / jtotal
    assert abs(gap) < TOTAL_RTOL
    assert gap == pytest.approx(MODEL_GAPS[(kind, train)], abs=1e-4)


def test_model_scopes_are_the_jax_models():
    """The port's models name their scopes where the JAX models call
    ``jax.named_scope``: ``layer_<i>`` and, inside, ``attention`` and
    ``mlp``; the forward's table and the backward's share them."""
    _, tm, batch = gpt2_case()
    flops, macs, _ = get_model_profile(model=tm, batch=batch, train=True,
                                       print_profile=False, device="cpu")
    counter = FlopCounter()
    tparams = params_from_numpy(tm.init(0), "cpu")
    for leaf in jax.tree_util.tree_leaves(tparams):
        leaf.requires_grad_(True)
    with counter.count():
        tm.apply(tparams, {"input_ids": torch.from_numpy(
            batch["input_ids"]).long()}, rng=None,
            train=True).float().sum().backward()
    scopes = set(counter.by_scope)
    assert {"layer_0/attention", "layer_0/mlp", "layer_1/attention",
            "layer_1/mlp", "<top>"} <= scopes
    assert counter.flops == flops
    h, s, b = 64, 16, 2
    # an MLP's matmuls: fc1 and fc2, forward and both backward products
    mlp = counter.by_scope["layer_0/mlp"]
    assert mlp >= 3 * 2 * (2 * b * s * h * 4 * h)


# ------------------------------------------------------------ the engine
def gpt2_engine(config):
    engine, *_ = tds.initialize(model=GPT2LMHead(GPT2Config(**GPT2_TINY)),
                                config=config, device="cpu")
    return engine


def gpt2_steps(engine, n, seed=0):
    ids = np.random.default_rng(seed).integers(0, 256, (2, 16))
    return [float(engine.train_batch(iter([{"input_ids": ids}])))
            for _ in range(n)]


def test_engine_profiler_wiring(cpu_devices):
    """``flops_profiler.enabled`` builds the profiler; it counts the step
    ``profile_step`` (forward and backward times the accumulation steps,
    plus the optimizer step); ``params`` is the JAX engine's
    ``params_count(engine._param_template)`` for the same model."""
    config = base_config(flops_profiler={"enabled": True, "profile_step": 2})
    engine = gpt2_engine(config)
    assert engine.flops_profiler is not None
    gpt2_steps(engine, 3)
    prof = engine.flops_profiler.profile
    assert prof is not None, "profiler did not run at profile_step"
    assert prof.flops > 0 and prof.macs == prof.flops // 2
    assert prof.flops == sum(prof.by_phase.values())
    assert prof.by_phase["step"] > 0 and prof.wall_ms > 0
    assert prof.matmul_flops > 0.8 * prof.by_phase["forward_backward"]
    jengine, *_ = jds.initialize(
        model=GPT2LMHeadTPU(JGPT2Config(**GPT2_TINY)), config=config,
        mesh=jmake_mesh({"data": 1}, devices=cpu_devices[:1]))
    assert prof.params == jparams(jengine._param_template)
    engine.close()


def test_profile_multiplies_the_micro_batch_by_accumulation():
    engine = gpt2_engine(base_config(
        train_batch_size=4, train_micro_batch_size_per_gpu=2,
        gradient_accumulation_steps=2,
        flops_profiler={"enabled": True, "profile_step": 1}))
    ids = np.random.default_rng(0).integers(0, 256, (2, 16))
    engine.train_batch(iter([{"input_ids": ids}] * 2))
    prof = engine.flops_profiler.profile
    one = FlopCounter()
    with one.count():
        engine.train_batch(iter([{"input_ids": ids}] * 2))
    # the unprofiled step's two micro-batches and step, counted directly
    assert prof.flops == one.flops
    engine.close()


def test_the_profiled_step_moves_no_loss_bit():
    on = gpt2_engine(base_config(flops_profiler={"enabled": True,
                                                 "profile_step": 2}))
    off = gpt2_engine(base_config())
    assert gpt2_steps(on, 3) == gpt2_steps(off, 3)
    assert torch.equal(on.master, off.master)
    assert on.flops_profiler.profile is not None
    assert off.flops_profiler is None


def test_profile_train_step_takes_one_step():
    engine = gpt2_engine(base_config())
    from deepspeed_tpu_torch.profiling import FlopsProfiler

    prof = FlopsProfiler(engine).profile_train_step(
        {"input_ids": np.random.default_rng(0).integers(0, 256, (2, 16))})
    assert engine.global_steps == 1 and prof.flops > 0


def test_wall_breakdown_keys():
    engine = gpt2_engine(base_config())
    batch = {"input_ids": np.random.default_rng(0).integers(0, 256, (2, 16))}
    out = wall_breakdown(engine, batch, steps=2, warmup=1, scan_steps=2)
    assert set(out) == {"fwd", "fwd_bwd", "bwd_derived", "cast_params",
                        "train_step", "opt_flatten_derived"}
    assert all(math.isfinite(v) for v in out.values())
    assert out["fwd_bwd"] > 0 and out["train_step"] > 0
    assert out["bwd_derived"] == out["fwd_bwd"] - out["fwd"]
    engine.close()
