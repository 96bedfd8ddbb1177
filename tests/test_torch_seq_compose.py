"""Sequence parallelism composed with the rest of the port's engine: the
dense and sparse attention cores on a ``seq`` mesh through the gather
core (K/V gathered, the kernels at each chunk's query-row offset), BERT's
heads, MoE under ``data`` and ``expert``, 1-bit Adam,
``sparse_gradients`` and the pipeline engine on ``seq``.

Op level, in this process, four ``seq`` shards of one process
(:func:`~deepspeed_tpu_torch.ops.transformer.gather_attention.gather_flash_attention_local`
and its sparse form) against one call on the whole sequence; the plain
versions and B4's bits at a query-row offset against the rows of the
whole call.

Engine level, the port on four gloo processes
(:func:`tests.torch_seq_compose_workers.compose_world`, one spawn for
the module) against the JAX engine on the same mesh over the conftest's
virtual CPU devices.  fp32; losses within ``RTOL`` over 5 steps, the
whole master within ``MASTER_ATOL`` (the tensor-parallel tests'
tolerances).  1-bit Adam runs the dense core: the JAX ring under 1-bit
Adam fails on this jaxlib (ROADMAP C), and the dense core is the same
math.  The pipeline engine at ``{pipe: 2, seq: 2}`` is held against the
JAX pipeline on that mesh and the port's own ``{pipe: 2, data: 2}``
run, with a masked cross entropy (a share of the labels -100) on the
GPT-like stack and on one with a port ``TransformerLayer`` on each
stage; the dense GPT-2 at ``{data: 2, seq: 2}`` against the port's own
``{data: 2}`` run too, with attention dropout as well.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from jax.experimental.compilation_cache import compilation_cache
from deepspeed_tpu.models import BertConfig as JBertConfig
from deepspeed_tpu.models import BertForPreTrainingTPU
from deepspeed_tpu.models import GPT2Config as JConfig
from deepspeed_tpu.models import GPT2LMHeadTPU
from deepspeed_tpu.models.bert import (
    BertForQuestionAnsweringTPU as JQA,
    BertForSequenceClassificationTPU as JCls)
from deepspeed_tpu.models.layers import TransformerLayer as JTransformerLayer
from deepspeed_tpu.models.layers import \
    cross_entropy_with_logits as j_masked_xent
from deepspeed_tpu.ops.sparse_attention import FixedSparsityConfig as JFixed
from deepspeed_tpu.parallel import make_mesh as jax_mesh
from deepspeed_tpu.runtime.pipe import LayerSpec as JLayerSpec
from deepspeed_tpu.runtime.pipe import PipelineModule as JPipelineModule
from deepspeed_tpu.runtime.pipe import TiedLayerSpec as JTiedLayerSpec
from deepspeed_tpu_torch.ops.sparse_attention import (
    BigBirdSparsityConfig, FixedSparsityConfig, VariableSparsityConfig)
from deepspeed_tpu_torch.ops.sparse_attention import \
    flash_block_sparse as fbs
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse import \
    block_sparse_attention
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.ops.transformer import gather_attention as ga
from deepspeed_tpu_torch.ops.transformer.ring_attention import visible_keys
from tests.unit.test_pipe import Embed as JEmbed
from tests.unit.test_pipe import Linear as JLinear
from tests.unit.test_pipe import _lm_head as j_lm_head

from . import torch_pipe_workers as P
from . import torch_seq_compose_workers as W
from . import torch_seq_workers as SW
from .test_torch_pipe import jax_gpt_like_specs, numpy_tree
from .test_torch_pipe import jax_train as jax_pipe_train
from .test_torch_tensor_parallel import (MASTER_ATOL, RTOL, jax_engine,
                                         jax_master, jax_train)
from .torch_dist import run_ranks

N = 4
OP_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def restore_jax_current_mesh():
    """The JAX engines built here make their mesh the JAX package's
    current mesh: the module puts back the mesh it found."""
    from deepspeed_tpu.parallel import mesh as jax_mesh_state

    prev = jax_mesh_state.get_current_mesh()
    yield
    jax_mesh_state.set_current_mesh(prev)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def fresh_compiles():
    """JAX compiles inside the block without the persistent cache (see
    ``tests/test_torch_sequence_parallel.py``)."""
    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", enabled)
        compilation_cache.reset_cache()


# ----------------------------------------------------------- op level
def _grads(fn, q, k, v, g):
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*x)
    return [out.detach()] + list(torch.autograd.grad(out, x, g))


@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["nodrop", "dropout"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "keymask"])
@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
def test_gather_core_matches_one_call(causal, masked, rate):
    """Four shards of the dense gather core (their rows at their offsets
    against the whole K/V, the keep bits their rows of one call's, the
    dk/dv partials summed) give one call's out and grads."""
    b, s, h, d = 2, 32, 2, 8
    q, k, v, g = W.torch_inputs(b, s, h, d, int(causal) + 2 * int(masked))
    kpm = None
    if masked:
        kpm = torch.zeros(b, s)
        kpm[:, 3 * s // 4 + 1:] = -1e9
    seed = torch.tensor([3, -4], dtype=torch.int32) if rate else None
    got = _grads(lambda *x: ga.gather_flash_attention_local(
        *x, N, causal, kpm, rate, seed), q, k, v, g)
    want = _grads(lambda *x: fa.FlashAttention.apply(
        *x, visible_keys(kpm), seed, causal, rate, 0, None), q, k, v, g)
    for label, x, y in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=OP_TOL,
                                   atol=OP_TOL, err_msg=label)


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
def test_plain_versions_at_an_offset_are_the_rows_of_one_call(causal):
    """The plain B1 and B2 at a chunk's query-row offset, against the
    keys its rows see, give that chunk's rows of one call's out, lse and
    dq; the chunks' dk and dv partials sum to one call's."""
    b, s, h, d = 2, 32, 2, 8
    q, k, v, g = W.torch_inputs(b, s, h, d, 7)
    out, lse = fa.flash_attention_reference(q, k, v, None, causal)
    dq, dk, dv = fa.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                                  None, causal)
    sl = s // N
    dk_sum, dv_sum = torch.zeros_like(dk), torch.zeros_like(dv)
    for r in range(N):
        kv_len = (r + 1) * sl if causal else s
        rows = slice(r * sl, (r + 1) * sl)
        o, l = fa.flash_attention_reference(
            q[:, rows], k[:, :kv_len], v[:, :kv_len], None, causal,
            q_offset=r * sl)
        np.testing.assert_allclose(o.numpy(), out[:, rows].numpy(),
                                   rtol=OP_TOL, atol=OP_TOL)
        np.testing.assert_allclose(l.numpy(), lse.view(b * h, s)[:, rows]
                                   .numpy(), rtol=OP_TOL, atol=OP_TOL)
        gq, gk, gv = fa.flash_attention_bwd_reference(
            q[:, rows], k[:, :kv_len], v[:, :kv_len], o, l, g[:, rows], None,
            causal, q_offset=r * sl)
        np.testing.assert_allclose(gq.numpy(), dq[:, rows].numpy(),
                                   rtol=OP_TOL, atol=OP_TOL)
        dk_sum[:, :kv_len] += gk
        dv_sum[:, :kv_len] += gv
    np.testing.assert_allclose(dk_sum.numpy(), dk.numpy(), rtol=OP_TOL,
                               atol=OP_TOL)
    np.testing.assert_allclose(dv_sum.numpy(), dv.numpy(), rtol=OP_TOL,
                               atol=OP_TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
def test_keep_bits_at_an_offset_are_the_rows_of_one_call(causal):
    """B4's plain version at a chunk's query-row offset (and its keys
    under ``causal``) gives bitwise that chunk's rows of one call's
    words; the words past its keys are 0 in the whole call's; the
    wrapper draws the same."""
    seed = torch.tensor([11, -7], dtype=torch.int32)
    b, h, s = 2, 3, 96
    whole = fa.philox_keep_bits(seed, b * h, s, s, 0.1, causal=causal)
    sl = s // N
    for r in range(N):
        kv_len = (r + 1) * sl if causal else s
        part = fa.philox_keep_bits(seed, b * h, sl, kv_len, 0.1,
                                   causal=causal, q_offset=r * sl)
        rows = whole[:, r * sl:(r + 1) * sl]
        assert torch.equal(part, rows[..., :part.shape[-1]])
        assert not rows[..., part.shape[-1]:].any()
        assert torch.equal(part, fa.draw_keep_bits(
            seed, b, h, sl, kv_len, 0.1, causal, q_offset=r * sl))


SPARSE_CASES = {
    "fixed_uni": (lambda: FixedSparsityConfig(
        num_heads=2, block=4, attention="unidirectional"), True),
    "fixed_bi": (lambda: FixedSparsityConfig(num_heads=2, block=4), False),
    "bigbird": (lambda: BigBirdSparsityConfig(num_heads=2, block=4),
                False),
    "variable_uni": (lambda: VariableSparsityConfig(
        num_heads=2, block=4, attention="unidirectional"), True),
    "variable_bi": (lambda: VariableSparsityConfig(num_heads=2, block=4),
                    False),
}


@pytest.mark.parametrize("q_agg", ["auto", "never"])
@pytest.mark.parametrize("name", sorted(SPARSE_CASES))
def test_sparse_gather_core_matches_one_call(name, q_agg):
    """Four shards of the sparse gather core (each its block rows of the
    whole layout at its offset: B6's plain versions at G = 4, B5's at
    G = 1) and the gather path on the same rows give one call's out and
    grads."""
    make, causal = SPARSE_CASES[name]
    b, s, h, d = 1, 64, 2, 8
    layout = make().make_layout(s)
    q, k, v, g = W.torch_inputs(b, s, h, d, len(name))
    want = _grads(lambda *x: fbs.flash_block_sparse_attention(
        *x, layout, causal, q_agg), q, k, v, g)
    got = _grads(lambda *x: ga.gather_block_sparse_attention_local(
        *x, layout, N, causal, q_agg), q, k, v, g)
    assert ga.seq_sparse_factor(layout, s, N, q_agg) == \
        (4 if q_agg == "auto" else 1)

    def gather_path(q_, k_, v_):
        outs = [block_sparse_attention(
            W.seq_rows_of(q_, N, r), k_, v_, ga.seq_rows(layout, N, r),
            causal=causal, q_offset=r * s // N) for r in range(N)]
        return torch.cat(outs, dim=1)

    gathered = _grads(gather_path, q, k, v, g)
    for label, x, y, z in zip(("out", "dq", "dk", "dv"), got, want,
                              gathered):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=OP_TOL,
                                   atol=OP_TOL, err_msg=label)
        np.testing.assert_allclose(z.numpy(), y.numpy(), rtol=OP_TOL,
                                   atol=OP_TOL, err_msg=label)


# ------------------------------------------------------- engine level
def _jgpt2(**kw):
    return GPT2LMHeadTPU(JConfig(**dict(W.TINY, **kw)))


def _jbert_cfg():
    return JBertConfig(**dict(W.BERT_TINY, attn_impl="auto"))


def jax_attention_specs():
    """:func:`tests.torch_seq_compose_workers.attention_specs` in the JAX
    package's layers."""
    def block():
        return [JLayerSpec(JTransformerLayer, P.HIDDEN, W.PIPE_HEADS,
                           **W.PIPE_LAYER),
                JLayerSpec(JLinear, P.HIDDEN, P.HIDDEN)]
    return ([JTiedLayerSpec("emb", JEmbed, P.VOCAB, P.HIDDEN,
                            tied_weight_attr="table")]
            + block() + block()
            + [JTiedLayerSpec("emb", JEmbed, P.VOCAB, P.HIDDEN,
                              forward_fn=j_lm_head,
                              tied_weight_attr="table")])


JAX_PIPE_SPECS = {"gpt": jax_gpt_like_specs, "attn": jax_attention_specs}


@pytest.fixture(scope="module")
def pipe_weights():
    """The pipeline stacks' whole weights, drawn by the JAX modules (as
    ``tests/test_torch_pipe.py`` draws them)."""
    return {kind: numpy_tree(JPipelineModule(
        specs(), loss_fn=j_masked_xent, seed_layers=True).init(
            jax.random.PRNGKey(0)))
        for kind, specs in JAX_PIPE_SPECS.items()}


def jax_pipe_run(kind, topo, weights):
    """The JAX ``PipelineEngine`` on ``topo`` with the masked cross
    entropy: the losses of ``STEPS`` steps."""
    n = int(np.prod(list(topo.values())))
    module = JPipelineModule(JAX_PIPE_SPECS[kind](), loss_fn=j_masked_xent,
                             partition_method="uniform")
    engine, *_ = jds.initialize(
        model=module, config=P.config(1),
        mesh=jax_mesh(topo, devices=jax.devices("cpu")[:n]),
        model_parameters=jax.tree_util.tree_map(jax.numpy.asarray,
                                                weights[kind]))
    return jax_pipe_train(engine, W.pipe_data(kind))


@pytest.fixture(scope="module")
def ref(tmp_path_factory, pipe_weights):
    """The JAX trajectories and the port's four ranks."""
    out = {}
    d2s2 = {"data": 2, "seq": 2}
    adam2 = W.config(W.ADAM, dp=2)
    _, params = W.gpt2()
    heads = W.head_params()
    cases = [
        ("gpt2_dense", _jgpt2(attn_impl="auto"), params, adam2, d2s2,
         SW.gpt2_batches),
        ("gpt2_sparse", _jgpt2(attn_impl="sparse",
                               sparsity_config=JFixed(**W.SPARSE)),
         params, adam2, d2s2, SW.gpt2_batches),
        ("bert_dense", BertForPreTrainingTPU(_jbert_cfg()),
         SW.bert()[1], W.config(W.LAMB, stage=1, dp=2), d2s2,
         SW.bert_batches),
        ("bert_qa", JQA(_jbert_cfg()), heads["qa"],
         W.config(W.ADAM, stage=1, dp=2), d2s2,
         lambda n: W.head_batches("qa", n)),
        ("bert_cls", JCls(_jbert_cfg(), num_labels=W.HEAD_LABELS),
         heads["cls"], W.config(W.ADAM, stage=1, dp=2), d2s2,
         lambda n: W.head_batches("cls", n)),
        # sparse_gradients changes the exchange, not the numbers: the
        # oracle is the JAX engine's dense exchange on the mesh (its own
        # sparse_gradients run of this head takes another trajectory,
        # at {data: 2} too: ROADMAP C)
        ("sgrad", JQA(_jbert_cfg()), heads["qa"],
         W.config(W.ADAM, stage=0, dp=2), d2s2,
         lambda n: W.head_batches("qa", n)),
        ("onebit", _jgpt2(attn_impl="auto"), params,
         W.config(W.ONEBIT, stage=0, dp=2, clip=0.0), d2s2,
         SW.gpt2_batches),
        ("moe_d2s2", _jgpt2(attn_impl="auto", **W.MOE),
         W.gpt2(**W.MOE)[1], adam2, d2s2, SW.gpt2_batches),
        ("moe_e2s2", _jgpt2(attn_impl="auto", **W.MOE),
         W.gpt2(**W.MOE)[1], W.config(W.ADAM), {"expert": 2, "seq": 2},
         SW.gpt2_batches),
    ]
    with fresh_compiles():
        for name, model, p, cfg, dims, batches in cases:
            eng = jax_engine(model, p, cfg, dims)
            out[name] = {"losses": jax_train(eng, batches(W.STEPS)),
                         "master": jax_master(eng)}
        out["pipe"] = {kind: jax_pipe_run(kind, {"pipe": 2, "seq": 2},
                                          pipe_weights)
                       for kind in JAX_PIPE_SPECS}
    tmp = tmp_path_factory.mktemp("seq_compose")
    out["ranks"] = run_ranks(W.compose_world, W.WORLD, tmp, pipe_weights,
                             timeout=600.0)
    out["data2"] = run_ranks(W.dense_data2, 2, tmp)
    return out


ENGINE_CASES = ["gpt2_dense", "gpt2_sparse", "bert_dense", "bert_qa",
                "bert_cls", "sgrad", "moe_d2s2", "moe_e2s2"]
# 1-bit Adam's compressed steps against the JAX engine's: the rule of
# tests/test_torch_tp_onebit.py (the warmup and the first step after the
# freeze within RTOL, the compressed ones within COMPRESSED_RTOL)
COMPRESSED_RTOL = 2e-2


@pytest.mark.parametrize("name", ENGINE_CASES)
def test_seq_composes_and_matches_the_jax_engine(ref, name):
    got = [r[name] for r in ref["ranks"]]
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"]
        np.testing.assert_array_equal(r["master"], got[0]["master"])
    want = ref[name]
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=RTOL,
                               atol=0)
    np.testing.assert_allclose(got[0]["master"], want["master"], rtol=0,
                               atol=MASTER_ATOL)


def test_onebit_at_data2_seq2_matches_the_jax_engine(ref):
    """1-bit Adam (the dense core, ``freeze_step`` 3) at ``{data: 2,
    seq: 2}``: the compressed phase sums the gradient over ``seq``
    before the compressed exchange over ``data``.  Against the JAX
    engine on the mesh by the 1-bit rule; every rank alike."""
    got = [r["onebit"] for r in ref["ranks"]]
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"]
    k = W.ONEBIT["params"]["freeze_step"] + 1
    want = ref["onebit"]["losses"]
    np.testing.assert_allclose(got[0]["losses"][:k], want[:k], rtol=RTOL,
                               atol=0)
    np.testing.assert_allclose(got[0]["losses"], want, rtol=COMPRESSED_RTOL,
                               atol=0)


@pytest.mark.parametrize("name", ["adam", "onebit", "attn_dropout"])
def test_dense_core_at_data2_seq2_matches_the_port_at_data2(ref, name):
    """The dense core at ``{data: 2, seq: 2}`` takes the port's own
    ``{data: 2}`` trajectory under Adam (losses and master), with
    attention dropout too (every seq rank draws the seed words from the
    layer's stream before the seq mixing, so the chunks drop the rows
    of the one call at ``{data: 2}``), and under 1-bit Adam by the 1-bit
    rule (the seq sum only reorders the gradient's additions, which the
    compressed steps' signs amplify)."""
    want = ref["data2"][0][name]
    got = ref["ranks"][0][{"adam": "gpt2_dense",
                           "attn_dropout": "gpt2_attn_dropout"}.get(
                               name, name)]
    if name == "onebit":
        k = W.ONEBIT["params"]["freeze_step"] + 1
        np.testing.assert_allclose(got["losses"][:k], want["losses"][:k],
                                   rtol=RTOL, atol=0)
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=COMPRESSED_RTOL, atol=0)
        return
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL,
                               atol=0)
    np.testing.assert_allclose(got["master"], want["master"], rtol=0,
                               atol=MASTER_ATOL)


def _pipe_seq_matches(ref, kind):
    got = [r["pipe"][f"{kind}_p2s2"]["losses"] for r in ref["ranks"]]
    assert all(x == got[0] for x in got)
    np.testing.assert_allclose(got[0], ref["pipe"][kind], rtol=2e-5,
                               atol=0)
    np.testing.assert_allclose(
        got[0], ref["ranks"][0]["pipe"][f"{kind}_p2d2"]["losses"],
        rtol=2e-5, atol=0)


def test_pipe_seq_matches_the_jax_pipe_and_the_port(ref):
    """``{pipe: 2, seq: 2}`` on the GPT-like stack with the port's masked
    cross entropy (a share of the labels -100, so the chunks count
    different numbers): every rank returns the same losses, the JAX
    pipeline's on that mesh and the port's at ``{pipe: 2, data: 2}``."""
    _pipe_seq_matches(ref, "gpt")


def test_pipe_seq_with_attention_layers_matches_the_jax_pipe(ref):
    """The same with a causal port ``TransformerLayer`` on each stage
    (its dense core gathers K/V over ``seq``): against the JAX pipeline
    on that mesh and the port at ``{pipe: 2, data: 2}``."""
    _pipe_seq_matches(ref, "attn")


def test_head_eval_returns_the_whole_logits(ref):
    """``eval_batch`` of the QA head returns the whole ``[b, s]`` start
    and end logits on every seq rank, and the classifier the ``[b,
    labels]`` logits, the same on the two seq ranks of a data rank."""
    ranks = ref["ranks"]
    for kind, shapes in (("qa", [(2, W.SEQ), (2, W.SEQ)]),
                         ("cls", [(2, W.HEAD_LABELS)])):
        got = [r[f"bert_{kind}"]["eval"] for r in ranks]
        assert [t.shape for t in got[0]] == shapes
        # ranks 0, 1 are the seq ranks of data rank 0 ({data: 2, seq: 2}
        # is data-major)
        for a, b in zip(got[0], got[1]):
            np.testing.assert_array_equal(a, b)


def _pos_mean(x):
    """A layer that mixes positions outside the port's attention cores."""
    return x.mean(dim=1, keepdim=True).expand_as(x)


@pytest.mark.parametrize("case", ["layer", "forward_fn"])
def test_pipe_seq_refuses_a_layer_that_does_not_declare_seq_parallel(case):
    """A pipeline stage runs its layers on its ``seq`` rank's chunk, so a
    layer (or a tied use's ``forward_fn``) without ``seq_parallel`` is
    refused at ``initialize`` naming A22 and the layer, before any
    collective; the stacks the tests train declare every layer."""
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.parallel import Mesh
    from deepspeed_tpu_torch.runtime.pipe import (PipelineModule,
                                                  TiedLayerSpec)

    for specs in (P.gpt_like_specs(), W.attention_specs()):
        assert PipelineModule(specs).seq_unready() == []
    specs = P.gpt_like_specs(2)
    if case == "layer":
        specs.insert(2, _pos_mean)
        unready = "2: _pos_mean"
    else:
        specs[-1] = TiedLayerSpec("emb", P.Embed, P.VOCAB, P.HIDDEN,
                                  forward_fn=lambda p, x: x @ p["table"].T,
                                  tied_weight_attr="table")
        unready = "3: <lambda>"
    module = PipelineModule(specs, loss_fn=P.xent_loss,
                            partition_method="uniform")
    assert module.seq_unready() == [unready]
    with pytest.raises(NotImplementedError, match=r"A22") as err:
        tds.initialize(model=module, config=P.config(1), device="cpu",
                       mesh=Mesh({"pipe": 2, "seq": 2}))
    assert unready in str(err.value)
