"""The port's training engine against the JAX engine.

A 10-step loss trajectory of a tiny GPT-2 (2 layers, hidden 64, vocab
256, seq 32; fp32, dropout off) through ``initialize`` and
``train_batch`` on both engines (the JAX one on ``make_mesh({"data":
1})``), for Adam and Lamb, gradient accumulation 1 and 2, clipping on
and off: rtol 1e-5 (the same fp32 arithmetic; the engines agree to
about 2e-7 here, and ROADMAP A5 asks for 1e-3).  Then the engine's own
contracts on the CPU: the step-wise API, the dataloader, the flat
gradient dtype, and the options it refuses.
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models import GPT2Config as JConfig
from deepspeed_tpu.models import GPT2LMHeadTPU
from deepspeed_tpu.parallel import make_mesh
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params
from deepspeed_tpu_torch.parallel import Mesh
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=64, embd_dropout=0.0, attn_dropout=0.0,
            resid_dropout=0.0)
TRAJ_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_batches(n, micro=2, seq=32, seed=1):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, size=(micro, seq))
             .astype(np.int32)} for _ in range(n)]


def ds_config(opt, acc, clip):
    return {"train_batch_size": 2 * acc, "gradient_accumulation_steps": acc,
            "steps_per_print": 10 ** 9, "gradient_clipping": clip,
            "optimizer": {"type": opt, "params": {"lr": 3e-3}},
            "zero_optimization": {"stage": 2}}


def torch_engine(config, params=None, **kw):
    params = random_params(GPT2Config(**TINY), seed=0) if params is None \
        else params
    return tds.initialize(model=GPT2LMHead(GPT2Config(**TINY)),
                          model_parameters=params, config=config,
                          device="cpu", **kw)


@pytest.mark.parametrize("opt,acc,clip", [
    ("Adam", 1, 0.0), ("Adam", 2, 1.0), ("Lamb", 1, 1.0), ("Lamb", 2, 0.0)])
def test_ten_step_trajectory_matches_the_jax_engine(opt, acc, clip):
    params = random_params(GPT2Config(**TINY), seed=0)
    batches = make_batches(10 * acc)
    mesh = make_mesh({"data": 1}, devices=jax.devices("cpu")[:1])
    jengine, *_ = jds.initialize(
        model=GPT2LMHeadTPU(JConfig(**TINY)),
        model_parameters=jax.tree_util.tree_map(jax.numpy.asarray, params),
        config=ds_config(opt, acc, clip), mesh=mesh)
    engine, *_ = torch_engine(ds_config(opt, acc, clip), params)
    it_j, it_t = iter(batches), iter(batches)
    want = [float(jengine.train_batch(it_j)) for _ in range(10)]
    got = [float(engine.train_batch(it_t)) for _ in range(10)]
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL, atol=0)


def test_sparse_trajectory_matches_the_jax_engine():
    """Six steps with ``attn_impl="sparse"`` (Fixed unidirectional, block
    16, seq 64), Lamb with clipping, on both engines: rtol 1e-5 as for
    the dense model."""
    from deepspeed_tpu.ops.sparse_attention import FixedSparsityConfig as J
    from deepspeed_tpu_torch.ops.sparse_attention import \
        FixedSparsityConfig as T

    skw = dict(num_heads=4, block=16, num_local_blocks=2,
               num_global_blocks=1, attention="unidirectional")
    params = random_params(GPT2Config(**TINY), seed=0)
    batches = make_batches(6, seq=64)
    mesh = make_mesh({"data": 1}, devices=jax.devices("cpu")[:1])
    jengine, *_ = jds.initialize(
        model=GPT2LMHeadTPU(JConfig(**dict(TINY, attn_impl="sparse",
                                           sparsity_config=J(**skw)))),
        model_parameters=jax.tree_util.tree_map(jax.numpy.asarray, params),
        config=ds_config("Lamb", 1, 1.0), mesh=mesh)
    engine, *_ = tds.initialize(
        model=GPT2LMHead(GPT2Config(**dict(TINY, attn_impl="sparse",
                                           sparsity_config=T(**skw)))),
        model_parameters=params, config=ds_config("Lamb", 1, 1.0),
        device="cpu")
    it_j, it_t = iter(batches), iter(batches)
    want = [float(jengine.train_batch(it_j)) for _ in range(6)]
    got = [float(engine.train_batch(it_t)) for _ in range(6)]
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL, atol=0)


BERT_TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=64,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                 max_predictions_per_seq=5)


def bert_batches(n, micro=2, seq=32, seed=2):
    """bing_bert batches: ids, a padded attention mask, token types,
    exactly 4 MLM labels a row (-100 elsewhere) and NSP labels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, 128, size=(micro, seq)).astype(np.int32)
        labels = np.full((micro, seq), -100, np.int32)
        for r in range(micro):
            pos = rng.permutation(seq)[:4]
            labels[r, pos] = ids[r, pos]
        mask = np.ones((micro, seq), np.int32)
        mask[-1, seq - 5:] = 0
        out.append({"input_ids": ids, "attention_mask": mask,
                    "token_type_ids": (np.arange(seq)[None] >= seq // 2)
                    .repeat(micro, 0).astype(np.int32),
                    "masked_lm_labels": labels,
                    "next_sentence_labels": rng.integers(0, 2, size=micro)
                    .astype(np.int32)})
    return out


def test_bert_trajectory_matches_the_jax_engine():
    """Ten steps of BERT pretraining (MLM gather + NSP, a padded mask),
    Lamb with accumulation 2 and clipping 1.0, on both engines: rtol 1e-5
    as for GPT-2."""
    from deepspeed_tpu.models.bert import BertConfig as JBert
    from deepspeed_tpu.models.bert import BertForPreTrainingTPU
    from deepspeed_tpu_torch.models.bert import BertConfig as TBert
    from deepspeed_tpu_torch.models.bert import BertForPreTraining, \
        random_params as bert_params

    params = bert_params(TBert(**BERT_TINY), seed=3)
    batches = bert_batches(20)
    mesh = make_mesh({"data": 1}, devices=jax.devices("cpu")[:1])
    config = ds_config("Lamb", 2, 1.0)
    jengine, *_ = jds.initialize(
        model=BertForPreTrainingTPU(JBert(**BERT_TINY)),
        model_parameters=jax.tree_util.tree_map(jax.numpy.asarray, params),
        config=dict(config), mesh=mesh)
    engine, *_ = tds.initialize(model=BertForPreTraining(TBert(**BERT_TINY)),
                                model_parameters=params, config=dict(config),
                                device="cpu")
    it_j, it_t = iter(batches), iter(batches)
    want = [float(jengine.train_batch(it_j)) for _ in range(10)]
    got = [float(engine.train_batch(it_t)) for _ in range(10)]
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL, atol=0)


def test_stepwise_api_equals_train_batch():
    config = ds_config("Adam", 2, 1.0)
    batches = make_batches(6)
    a, *_ = torch_engine(dict(config))
    b, *_ = torch_engine(dict(config))
    it = iter(batches)
    fused = [float(a.train_batch(it)) for _ in range(3)]
    stepwise = []
    for i in range(3):
        losses = []
        for batch in batches[2 * i:2 * i + 2]:
            loss = b.forward(batch)
            b.backward(loss)
            losses.append(float(loss.detach()))
            b.step()
        stepwise.append(float(np.mean(losses)))
    assert b.global_steps == 3 and b.micro_steps == 6
    np.testing.assert_allclose(stepwise, fused, rtol=1e-6)
    assert torch.equal(a.master, b.master)


def test_eval_batch_and_the_training_dataloader():
    samples = [{"input_ids": row} for row in
               np.random.default_rng(3).integers(0, 256, size=(10, 32))]
    engine, _, loader, _ = torch_engine(ds_config("Adam", 1, 0.0),
                                        training_data=samples)
    assert isinstance(loader, DeepSpeedDataLoader) and len(loader) == 5
    ids = np.stack([s["input_ids"] for s in samples[:2]])
    first = {"input_ids": ids, "labels": ids}   # labels: eval gives a loss
    before = float(engine.eval_batch(first))
    for _ in range(6):  # wraps past the 5 batches of one epoch
        engine.train_batch()
    after = float(engine.eval_batch(first))
    assert after != before   # the steps moved the weights
    assert loader.state_dict() == {"epoch": 2, "samples_yielded": 2}
    logits = engine.eval_batch(iter(make_batches(3)))   # no labels
    assert logits.shape == (2, 32, 256)


def test_dataloader_resumes_at_its_cursor():
    data = list(range(23))
    loader = DeepSpeedDataLoader(data, 4, shuffle=True, seed=5)
    it = iter(loader)
    first = [next(it).tolist() for _ in range(3)]
    state = loader.state_dict()
    rest = [b.tolist() for b in it]
    again = DeepSpeedDataLoader(data, 4, shuffle=True, seed=5)
    again.load_state_dict(state)
    assert [b.tolist() for b in again] == rest
    assert state == {"epoch": 1, "samples_yielded": 12}
    assert len(first) == 3 and len(rest) == 2


def test_dataloader_slices_the_global_batch_per_rank():
    """Every rank iterates the same seeded order and keeps its contiguous
    slice of each global micro-batch; the cursor counts global samples,
    so a run resumes at another data-parallel degree, a ragged tail
    splits in whole rows a rank, and a rank outside the world or a batch
    that does not split raises."""
    data = list(range(23))
    full = [b.tolist() for b in DeepSpeedDataLoader(data, 4, shuffle=True,
                                                    seed=5)]
    halves = [[b.tolist() for b in DeepSpeedDataLoader(
        data, 4, shuffle=True, seed=5, data_parallel_world_size=2,
        data_parallel_rank=r)] for r in range(2)]
    assert [a + b for a, b in zip(*halves)] == full
    loader = DeepSpeedDataLoader(data, 4, shuffle=True, seed=5,
                                 data_parallel_world_size=2,
                                 data_parallel_rank=1)
    it = iter(loader)
    next(it), next(it)
    state = loader.state_dict()
    assert state == {"epoch": 1, "samples_yielded": 8}
    one = DeepSpeedDataLoader(data, 4, shuffle=True, seed=5)
    one.load_state_dict(state)
    assert [b.tolist() for b in one] == full[2:]
    tail = DeepSpeedDataLoader(list(range(7)), 4, drop_last=False,
                               data_parallel_world_size=2,
                               data_parallel_rank=1)
    assert [b.tolist() for b in tail] == [[2, 3], [5]]
    with pytest.raises(ValueError, match="outside"):
        DeepSpeedDataLoader(data, 4, data_parallel_world_size=2,
                            data_parallel_rank=2)
    with pytest.raises(ValueError, match="split"):
        DeepSpeedDataLoader(data, 3, data_parallel_world_size=2)


@pytest.mark.parametrize("bf16,acc,grad_dtype,acc_buffer", [
    (True, 1, torch.bfloat16, False), (True, 2, torch.bfloat16, True),
    (False, 2, torch.float32, False)])
def test_flat_gradient_dtype_follows_the_jax_rule(bf16, acc, grad_dtype,
                                                  acc_buffer):
    """Gradients land in one flat buffer in the compute dtype; an fp32
    buffer sums micro-batches only under bf16 with accumulation."""
    config = dict(ds_config("Adam", acc, 0.0), bf16={"enabled": bf16})
    engine, *_ = torch_engine(config)
    assert engine._grad.dtype == grad_dtype
    assert (engine._acc is not None) == acc_buffer
    assert (engine.params["wte"].grad.untyped_storage().data_ptr()
            == engine._grad.untyped_storage().data_ptr())
    loss = engine.forward(make_batches(1)[0])
    engine.backward(loss)
    buf = engine._acc if acc_buffer else engine._grad
    assert float(buf.float().abs().sum()) > 0
    flat_wte = engine.flat.unflatten_params(buf)["wte"]
    assert flat_wte.shape == (256, 64)
    assert float(flat_wte.float().abs().sum()) > 0


@pytest.mark.parametrize("change,error,match", [
    pytest.param({"fp16": {"enabled": True}}, None, "float16",
                 id="change0-None-float16"),
    pytest.param({"zero_optimization": {"stage": 3, "cpu_offload": True}},
                 None, "zero3-offload", id="change1-None-zero3-offload"),
    pytest.param({"zero_optimization": {"stage": 3}}, None, "zero3",
                 id="change2-None-zero3"),
    pytest.param({"optimizer": {"type": "OneBitAdam",
                                "params": {"lr": 1e-3}},
                  "zero_optimization": {"stage": 0}}, None, "onebit",
                 id="change3-None-onebit"),
    pytest.param({"optimizer": {"type": "Sgd", "params": {}}}, ValueError,
                 "sgd", id="change4-ValueError-sgd"),
    pytest.param({"zero_optimization": {"stage": 2, "cpu_offload": True},
                  "mesh": {"data": 2}}, RuntimeError, "process group",
                 id="change5-NotImplementedError-A9"),
    pytest.param({"zero_optimization": {"stage": 2, "overlap_comm": True},
                  "mesh": {"data": 2}}, RuntimeError, "process group",
                 id="change6-RuntimeError-process-group")])
def test_unported_options_raise(change, error, match):
    """Options the port once refused.  The ids keep the refusals these
    cases once were: fp16 (A4) builds an engine whose compute params and
    flat gradient are fp16, with the JAX package's dynamic scale;
    ZeRO-3, alone and under offload, and 1-bit Adam (A8, A14) build and
    train; the bucketed ``overlap_comm`` at two ranks (A8) builds its
    bucket plan, and offload at two ranks (A9) its host shards, and each
    goes on to its first collective, which a mesh without a process
    group cannot make (a ``mesh`` here, handed to ``initialize``;
    ``tests/test_torch_offload_dp.py`` trains offload on gloo ranks)."""
    change = dict(change)
    kw = {"mesh": Mesh(change.pop("mesh"))} if "mesh" in change else {}
    config = dict(ds_config("Adam", 1, 0.0), **change)
    if kw:
        config["train_batch_size"] *= kw["mesh"].size("data")
    if error is not None:
        with pytest.raises(error, match=match):
            torch_engine(config, **kw)
        return
    engine, *_ = torch_engine(config)
    if match == "float16":
        assert str(engine.compute_dtype) == f"torch.{match}"
        assert engine._compute.dtype == engine._grad.dtype == torch.float16
        assert engine.fp16_enabled() and engine.dynamic_loss_scale()
        assert engine.loss_scale == 2.0 ** 32 and engine.skipped_steps == 0
        return
    losses = [float(engine.train_batch(iter([b])))
              for b in make_batches(2)]
    assert all(np.isfinite(losses))
    if match == "onebit":
        assert type(engine.optimizer).__name__ == "OnebitAdam"
        assert engine.optimizer.freeze_step == 100000
        assert engine.opt_state.step == 2
        return
    # ZeRO-3: no compute params persist between the steps
    assert engine.zero_optimization_stage() == 3
    assert engine._compute.untyped_storage().nbytes() == 0
    assert engine.zero_cpu_offload() == (match == "zero3-offload")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tds.initialize(model=GPT2LMHead(GPT2Config(**TINY)),
                       config=ds_config("Adam", 1, 0.0))


def test_model_init_supplies_params_and_client_optimizers_are_gated():
    from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam

    engine, opt, _, sched = tds.initialize(
        model=GPT2LMHead(GPT2Config(**TINY)), config=dict(
            ds_config("Adam", 1, 0.0), seed=4,
            scheduler={"type": "WarmupLR",
                       "params": {"warmup_num_steps": 5}}),
        device="cpu")
    want = random_params(GPT2Config(**TINY), seed=4)["wte"]
    np.testing.assert_array_equal(engine.params["wte"].detach().numpy(),
                                  want)
    assert isinstance(opt, FusedAdam) and sched is not None

    class MyOpt(FusedAdam):
        pass

    with pytest.raises(ValueError, match="zero_allow_untested_optimizer"):
        torch_engine(ds_config("Adam", 1, 0.0), optimizer=MyOpt())
    engine, opt, *_ = torch_engine(
        dict(ds_config("Adam", 1, 0.0), zero_allow_untested_optimizer=True),
        optimizer=MyOpt())
    assert type(opt).__name__ == "MyOpt"


def test_flat_master_layout_is_the_jax_one():
    """Leaves in ``jax.tree_util`` order, each on its own rows: the flat
    master's segments and its unpadded form are the JAX package's."""
    from deepspeed_tpu.ops.op_common import build_segments
    from deepspeed_tpu_torch.runtime.zero.coordinator import \
        FlatParamCoordinator

    params = random_params(GPT2Config(**TINY), seed=2)
    leaves = jax.tree_util.tree_leaves(params)
    coord = FlatParamCoordinator(params, stage=2)
    assert tuple(coord.segments) == tuple(build_segments(
        [leaf.size for leaf in leaves]))
    master = coord.flatten_to_master(params, "cpu")
    np.testing.assert_array_equal(
        coord.gather_master_unpadded(master),
        np.concatenate([np.ravel(leaf) for leaf in leaves]))
    views = coord.unflatten_params(master)
    np.testing.assert_array_equal(views["blocks"]["layer_1"]["fc2"]["kernel"]
                                  .numpy(),
                                  params["blocks"]["layer_1"]["fc2"]["kernel"])
    assert views["wte"].untyped_storage().data_ptr() == \
        master.untyped_storage().data_ptr()


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_flat_master_partitions_over_data_parallel_ranks(stage):
    """At dp=2 the rows pad to a multiple of 2 (stages 1, 2, as the JAX
    coordinator pads) and each rank of a mesh owns a contiguous half of
    the master at stages 1 and 2 (the whole at stage 0); a checkpoint's
    unpadded form re-pads onto each rank's rows."""
    from deepspeed_tpu.ops.op_common import build_segments
    from deepspeed_tpu_torch.runtime.zero.coordinator import \
        FlatParamCoordinator

    params = random_params(GPT2Config(**TINY), seed=2)
    leaves = jax.tree_util.tree_leaves(params)
    whole = FlatParamCoordinator(params, stage=stage).flatten_to_master(
        params, "cpu")
    unpadded = np.concatenate([np.ravel(leaf) for leaf in leaves])
    parts = []
    for rank in range(2):
        coord = FlatParamCoordinator(params, stage=stage, dp_size=2,
                                     dp_rank=rank,
                                     mesh=Mesh({"data": 2}, rank=rank))
        assert tuple(coord.segments) == tuple(build_segments(
            [leaf.size for leaf in leaves], pad_to=2 if stage else 1))
        assert coord.partitioned == (stage > 0)
        part = coord.flatten_to_master(params, "cpu")
        assert part.shape == coord.shard_shape
        again = coord.scatter_master_from_unpadded(unpadded,
                                                   torch.zeros_like(part))
        assert torch.equal(again, part)
        parts.append(part)
    if stage:
        assert coord.segments.rows % 2 == 0
        torch.testing.assert_close(torch.cat(parts)[:whole.shape[0]], whole,
                                   rtol=0, atol=0)
    else:
        assert torch.equal(parts[0], whole) and torch.equal(parts[1], whole)
