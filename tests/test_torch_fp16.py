"""fp16 mixed precision in the port (ROADMAP A4) against the JAX package,
on the CPU.

- The loss scaler: the port's ``update_scale_state`` and
  ``DynamicLossScaler`` walk seeded overflow sequences of 200 steps
  exactly as the JAX ones do (hysteresis 1 and 2, consecutive hysteresis
  on and off, the min-scale clamp).
- The engine: a tiny GPT-2 and a tiny BERT (2 layers, hidden 128,
  head_dim 64, dropout 0) train 10 fp16 steps on both engines.  Step 3
  overflows on purpose: an inf written into one compute parameter
  (``fc1/bias[0]`` of the first layer) before it.  BERT's batch has no
  float leaf that reaches its loss unmasked (the attention mask is
  compared with 0 on the flash path, so a NaN there masks the key), so
  both models take the same poison.  The skip pattern, ``skipped_steps``
  and the scale trace are equal exactly; the losses agree to rtol 1e-2
  and the final masters as ``MASTER_ATOL`` states (fp16 products round
  at other places in XLA's CPU matmuls and torch's).  These runs keep the scale
  at or below 2^24, where the JAX engine's fp16 1/scale is exact.
- The JAX unit tests of the fp16 engine and config, ported.
- Checkpoints: a JAX fp16 run with skipped steps and a moved scale
  resumes in the port with its scale state, and the reverse.
- The JAX unscale quirk above 2^24 (ROADMAP C): the port does not copy
  it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.parallel import make_mesh
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
from deepspeed_tpu_torch.models.bert import BertConfig, BertForPreTraining
from deepspeed_tpu_torch.models.bert import random_params as bert_params
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as tls

from .torch_simple_model import SimpleModel, base_config, random_batches

GPT2_TINY = dict(vocab_size=256, hidden_size=128, num_layers=2,
                 num_heads=2, max_position_embeddings=64, embd_dropout=0.0,
                 attn_dropout=0.0, resid_dropout=0.0)
BERT_TINY = dict(vocab_size=128, hidden_size=128, num_hidden_layers=2,
                 num_attention_heads=2, max_position_embeddings=64,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                 max_predictions_per_seq=5)
FP16 = {"enabled": True, "initial_scale_power": 12, "loss_scale_window": 3,
        "hysteresis": 2, "min_loss_scale": 1}
POISON_STEP = 3
LOSS_RTOL = 1e-2
# Adam moves a weight about lr a step whatever its gradient's size, so a
# tiny gradient that rounds to the other sign in one engine's fp16 costs
# up to 2·lr a step: every element within 2·lr·9 applied steps, and all
# but 0.2% of them within 1e-4
MASTER_ATOL = 2 * 1e-3 * 9
MASTER_CLOSE = 1e-4
MASTER_FAR_SHARE = 2e-3
HIDDEN = 16


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cpu_mesh():
    return make_mesh({"data": 1}, devices=jax.devices("cpu")[:1])


# ------------------------------------------------------------------ scaler
def overflow_sequence(seed, n=200, p=0.3):
    return [bool(x) for x in np.random.default_rng(seed).random(n) < p]


SCALER_CASES = {
    "no_hysteresis": dict(delayed_shift=1, consecutive_hysteresis=False,
                          init_scale=2.0 ** 16, min_scale=1.0),
    "hysteresis_2": dict(delayed_shift=2, consecutive_hysteresis=False,
                         init_scale=2.0 ** 16, min_scale=1.0),
    "consecutive_hysteresis_2": dict(delayed_shift=2,
                                     consecutive_hysteresis=True,
                                     init_scale=2.0 ** 16, min_scale=1.0),
    "consecutive_no_hysteresis": dict(delayed_shift=1,
                                      consecutive_hysteresis=True,
                                      init_scale=2.0 ** 16, min_scale=1.0),
    # starts near the floor and overflows often: the clamp at min_scale
    "min_scale_clamp": dict(delayed_shift=2, consecutive_hysteresis=False,
                            init_scale=8.0, min_scale=2.0, p=0.7),
}


@pytest.mark.parametrize("name", sorted(SCALER_CASES))
def test_update_scale_state_equals_jax(name):
    case = dict(SCALER_CASES[name])
    p = case.pop("p", 0.3)
    init, min_scale = case.pop("init_scale"), case.pop("min_scale")
    kw = dict(case, scale_window=5, min_scale=min_scale)
    js = jls.DynamicScaleState.create(init, case["delayed_shift"])
    ts = tls.DynamicScaleState.create(init, case["delayed_shift"])
    hit_floor = False
    for overflow in overflow_sequence(len(name), p=p):
        js = jls.update_scale_state(js, overflow, **kw)
        ts = tls.update_scale_state(ts, overflow, **kw)
        want = (float(js.cur_scale), int(js.cur_iter),
                int(js.last_overflow_iter), int(js.cur_hysteresis))
        assert tuple(ts) == want
        hit_floor |= ts.cur_scale == min_scale
    if name == "min_scale_clamp":
        assert hit_floor


@pytest.mark.parametrize("name", sorted(SCALER_CASES))
def test_dynamic_loss_scaler_class_equals_jax(name):
    case = dict(SCALER_CASES[name])
    p = case.pop("p", 0.3)
    kw = dict(case, scale_window=5, floor_patience=3)
    j, t = jls.DynamicLossScaler(**kw), tls.DynamicLossScaler(**kw)
    for overflow in overflow_sequence(len(name) + 1, p=p):
        j.update_scale(overflow)
        t.update_scale(overflow)
        fields = ("cur_scale", "cur_iter", "last_overflow_iter",
                  "cur_hysteresis", "consecutive_floor_overflows",
                  "floor_stuck")
        assert [getattr(t, f) for f in fields] == \
            [getattr(j, f) for f in fields]


# ------------------------------------------------------------------ engine
def gpt2_batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, size=(2, 64)).astype(
        np.int32)} for _ in range(n)]


def bert_batches(n, seed=2, micro=2, seq=64):
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


def fp16_config(**overrides):
    cfg = {"train_batch_size": 2, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "zero_optimization": {"stage": 2}, "fp16": dict(FP16)}
    cfg.update(overrides)
    return cfg


def engines(kind, config, params=None):
    """The JAX engine and the port's on the same weights, and the path of
    the compute parameter a forced overflow poisons."""
    if kind == "gpt2":
        from deepspeed_tpu.models import GPT2Config as JGPT2
        from deepspeed_tpu.models import GPT2LMHeadTPU

        params = random_params(GPT2Config(**GPT2_TINY), seed=0) \
            if params is None else params
        jmodel = GPT2LMHeadTPU(JGPT2(**GPT2_TINY))
        tmodel = GPT2LMHead(GPT2Config(**GPT2_TINY))
        poison = ("blocks", "layer_0", "fc1", "bias")
    else:
        from deepspeed_tpu.models.bert import BertConfig as JBert
        from deepspeed_tpu.models.bert import BertForPreTrainingTPU

        params = bert_params(BertConfig(**BERT_TINY), seed=3) \
            if params is None else params
        jmodel = BertForPreTrainingTPU(JBert(**BERT_TINY))
        tmodel = BertForPreTraining(BertConfig(**BERT_TINY))
        poison = ("bert", "encoder", "layer_0", "fc1", "bias")
    jengine, *_ = jds.initialize(
        model=jmodel, model_parameters=jax.tree_util.tree_map(jnp.asarray,
                                                              params),
        config=dict(config), mesh=cpu_mesh())
    tengine, *_ = tds.initialize(model=tmodel, model_parameters=params,
                                 config=dict(config), device="cpu")
    return jengine, tengine, poison


def poison_jax(engine, path):
    node = engine._module_params
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = node[path[-1]].at[0].set(jnp.inf)


def poison_port(engine, path):
    node = engine.params
    for key in path[:-1]:
        node = node[key]
    with torch.no_grad():
        node[path[-1]][0] = float("inf")


def run(engine, batches, poison, poisoner):
    """Steps over ``batches``; the compute parameter at ``poison`` is set
    to inf before step ``POISON_STEP``.  Returns (losses, scale trace,
    skipped trace)."""
    losses, scales, skipped = [], [], []
    it = iter(batches)
    for step in range(len(batches)):
        if step == POISON_STEP:
            poisoner(engine, poison)
        losses.append(float(np.asarray(engine.train_batch(it))))
        scales.append(float(engine.loss_scale))
        skipped.append(int(engine.skipped_steps))
    return losses, scales, skipped


def jax_master(engine):
    return np.asarray(jax.device_get(engine.get_master_params()))


@pytest.mark.parametrize("kind", ["gpt2", "bert"])
def test_ten_fp16_steps_match_the_jax_engine(kind):
    """10 steps with one forced overflow: the same steps skipped, the same
    scale after every step (hysteresis 2 spends one unit on the overflow,
    the window of 3 doubles the scale twice), losses to rtol 1e-2, the
    final master to atol 2e-3, and the port's compute params fp16."""
    jengine, tengine, poison = engines(kind, fp16_config())
    assert tengine.compute_dtype == torch.float16
    assert tengine._grad.dtype == torch.float16 and tengine._acc is None
    batches = gpt2_batches(10) if kind == "gpt2" else bert_batches(10)
    jl, js, jk = run(jengine, batches, poison, poison_jax)
    tl, ts, tk = run(tengine, batches, poison, poison_port)
    assert tk == jk and tk[-1] == 1 and tk.index(1) == POISON_STEP
    assert ts == js and max(ts) <= 2.0 ** 24
    assert ts[POISON_STEP] == ts[POISON_STEP - 1]   # hysteresis spent
    assert len(set(ts)) > 1                         # the window grew it
    assert not np.isfinite(tl[POISON_STEP]) and not np.isfinite(
        jl[POISON_STEP])
    keep = [i for i in range(10) if i != POISON_STEP]
    np.testing.assert_allclose(np.array(tl)[keep], np.array(jl)[keep],
                               rtol=LOSS_RTOL, atol=0)
    want = jax_master(jengine)
    assert want.shape == tuple(tengine.master.shape)
    diff = np.abs(tengine.master.numpy() - want)
    assert diff.max() <= MASTER_ATOL
    assert (diff > MASTER_CLOSE).mean() <= MASTER_FAR_SHARE


def test_skipped_step_leaves_master_moments_and_schedule_unchanged():
    """A skipped step leaves the master and both moments bitwise as they
    were, and neither the optimizer's step count nor the LR schedule
    moves; the compute params are the master's cast again after it."""
    config = fp16_config(scheduler={"type": "WarmupLR", "params": {
        "warmup_num_steps": 5}})
    _, engine, poison = engines("gpt2", config)
    batches = gpt2_batches(3)
    engine.train_batch(iter(batches[:1]))
    before = [engine.master.clone(), engine.opt_state.exp_avg.clone(),
              engine.opt_state.exp_avg_sq.clone()]
    step, lr = engine.opt_state.step, engine.get_lr()[0]
    poison_port(engine, poison)
    engine.train_batch(iter(batches[1:2]))
    assert engine.skipped_steps == 1 and engine.global_steps == 2
    after = [engine.master, engine.opt_state.exp_avg,
             engine.opt_state.exp_avg_sq]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert engine.opt_state.step == step and engine.get_lr()[0] == lr
    assert torch.equal(engine._compute, engine.master.to(torch.float16))
    engine.train_batch(iter(batches[2:]))
    assert engine.get_lr()[0] != lr and engine.opt_state.step == step + 1


def test_accumulation_sums_fp16_grads_in_fp32():
    """With accumulation the micro-batches sum in an fp32 buffer, as in
    the JAX rule (``engine.py:1899-1913``), and the two-step run matches
    the JAX engine's scale trace."""
    config = fp16_config(train_batch_size=4, gradient_accumulation_steps=2)
    jengine, tengine, _ = engines("gpt2", config)
    assert tengine._acc is not None and tengine._acc.dtype == torch.float32
    batches = gpt2_batches(8)
    jit, tit = iter(batches), iter(batches)
    for _ in range(4):
        jl = float(np.asarray(jengine.train_batch(jit)))
        tl = float(tengine.train_batch(tit))
        assert tengine.loss_scale == float(jengine.loss_scale)
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)


# -------------------------------------------- ported JAX unit tests (fp16)
def simple_engine(config, nlayers=1):
    model = SimpleModel(HIDDEN, nlayers=nlayers)
    engine, *_ = tds.initialize(model=model, model_parameters=model.init(0),
                                config=config, device="cpu")
    return engine


def test_fp16_dynamic_loss_scale_skips():
    """Overflow skips the update, halves the scale and counts the skip
    (``tests/unit/test_engine.py::test_fp16_dynamic_loss_scale_skips``)."""
    config = base_config(
        fp16={"enabled": True, "initial_scale_power": 4,
              "loss_scale_window": 2, "hysteresis": 1,
              "min_loss_scale": 0.25})
    engine = simple_engine(config)
    assert engine.loss_scale == 2 ** 4
    batches = random_batches(4, 16, HIDDEN, seed=1)
    master_before = engine.master.clone()
    x, y = batches[0]
    x_bad = x.copy()
    x_bad[0, 0] = np.float32(np.inf)
    engine.train_batch(iter([(x_bad, y)]))
    assert engine.skipped_steps == 1
    assert engine.loss_scale == 2 ** 3
    assert torch.equal(engine.master, master_before)
    engine.train_batch(iter([batches[1]]))
    assert engine.skipped_steps == 1
    assert not torch.equal(engine.master, master_before)


def test_scale_window_growth():
    """``tests/unit/test_engine.py::test_scale_window_growth``: 4 good
    steps with window 2 double the scale twice."""
    config = base_config(
        fp16={"enabled": True, "initial_scale_power": 4,
              "loss_scale_window": 2, "hysteresis": 1})
    engine = simple_engine(config)
    for b in random_batches(4, 16, HIDDEN, seed=2):
        engine.train_batch(iter([b]))
    assert engine.loss_scale == 2 ** 6


def test_fp16_and_bf16_exclusive():
    """``tests/unit/test_config.py::test_fp16_and_bf16_exclusive``."""
    with pytest.raises(AssertionError):
        DeepSpeedConfig({"train_batch_size": 8, "fp16": {"enabled": True},
                         "bf16": {"enabled": True}})


def test_fp16_dynamic_loss_scale_args():
    """``tests/unit/test_config.py::test_fp16_dynamic_loss_scale_args``,
    and each parsed value equal to the JAX config's."""
    param = {"train_batch_size": 8, "fp16": {
        "enabled": True, "initial_scale_power": 16,
        "loss_scale_window": 500, "hysteresis": 4, "min_loss_scale": 0.5}}
    cfg = DeepSpeedConfig(dict(param))
    assert cfg.dynamic_loss_scale_args == {
        "init_scale": 2 ** 16, "scale_window": 500, "delayed_shift": 4,
        "min_scale": 0.5}
    jcfg = JConfig(dict(param), world_size=1)
    for name in ("fp16_enabled", "loss_scale", "initial_dynamic_scale",
                 "dynamic_loss_scale_args"):
        assert getattr(cfg, name) == getattr(jcfg, name)


# ------------------------------------------------------------- checkpoints
def scale_trace(engine, batches):
    it = iter(batches)
    out = []
    for _ in batches:
        loss = float(np.asarray(engine.train_batch(it)))
        out.append((float(engine.loss_scale), int(engine.skipped_steps),
                    loss))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fp16_checkpoint_resumes_across_packages(writer, tmp_path):
    """A run with a skipped step and a moved scale saves; a fresh engine
    of the other package loads it, and both take 3 more steps with the
    same scale and skipped trace (losses to rtol 1e-2).  ``meta.json``'s
    ``scale_state`` has the JAX package's keys and types."""
    jengine, tengine, poison = engines("gpt2", fp16_config())
    saver, poisoner = ((jengine, poison_jax) if writer == "jax"
                       else (tengine, poison_port))
    batches = gpt2_batches(8)
    run(saver, batches[:5], poison, poisoner)
    saved_scale = float(saver.loss_scale)
    assert saver.skipped_steps == 1 and saved_scale != 2.0 ** 12
    saver.save_checkpoint(str(tmp_path), sync=True)
    want = scale_trace(saver, batches[5:])

    j2, t2, _ = engines("gpt2", fp16_config(),
                        params=random_params(GPT2Config(**GPT2_TINY), 9))
    loader = t2 if writer == "jax" else j2
    path, _ = loader.load_checkpoint(str(tmp_path))
    assert path is not None
    assert loader.skipped_steps == 1
    assert float(loader.loss_scale) == saved_scale
    got = scale_trace(loader, batches[5:])
    assert [g[:2] for g in got] == [w[:2] for w in want]
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                               rtol=LOSS_RTOL)
    with open(tmp_path / "global_step5" / "meta.json") as f:
        meta = json.load(f)
    assert list(meta["scale_state"]) == ["cur_scale", "cur_iter",
                                         "last_overflow_iter",
                                         "cur_hysteresis"]
    assert [type(v) for v in meta["scale_state"].values()] == [
        float, int, int, int]
    assert meta["skipped_steps"] == 1


def test_meta_scale_state_matches_the_jax_engines(tmp_path):
    """The same fp16 run saved by both packages: equal ``scale_state`` and
    ``skipped_steps`` in ``meta.json``, value for value."""
    jengine, tengine, poison = engines("gpt2", fp16_config())
    batches = gpt2_batches(5)
    run(jengine, batches, poison, poison_jax)
    run(tengine, batches, poison, poison_port)
    jengine.save_checkpoint(str(tmp_path / "jax"), sync=True)
    tengine.save_checkpoint(str(tmp_path / "port"), sync=True)
    metas = [json.load(open(tmp_path / who / "global_step5" / "meta.json"))
             for who in ("jax", "port")]
    for key in ("scale_state", "skipped_steps"):
        assert metas[0][key] == metas[1][key]


# -------------------------------------------------- the unscale above 2^24
def test_unscale_above_2_24_applies_the_gradient():
    """ROADMAP C: at a scale above 2^24 the JAX engine's fp16 1/scale
    rounds to 0 (``engine.py:3176-3180``), so a step whose scaled
    gradients stay finite is not skipped and applies a zero gradient: the
    master does not move.  The port unscales in fp32 there and applies
    the gradient.  Tiny inputs keep the gradients finite at 2^32 (this is
    the only test here that leaves the scale above 2^24)."""
    assert np.float16(2.0 ** -25) == 0 and np.float16(2.0 ** -24) != 0
    config = base_config(fp16={"enabled": True, "initial_scale_power": 32,
                               "hysteresis": 1})
    model = SimpleModel(HIDDEN, nlayers=2)
    params = model.init(0)
    rng = np.random.default_rng(0)
    x = (1e-3 * rng.normal(size=(16, HIDDEN))).astype(np.float32)
    batch = (x, np.zeros((16, HIDDEN), np.float32))

    from tests.unit.simple_model import SimpleModel as JSimple

    jengine, *_ = jds.initialize(
        model=JSimple(HIDDEN, nlayers=2),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, params),
        config=dict(config), mesh=cpu_mesh())
    jbefore = jax_master(jengine)
    jengine.train_batch(iter([batch]))
    assert jengine.skipped_steps == 0
    np.testing.assert_array_equal(jax_master(jengine), jbefore)

    engine = simple_engine(dict(config), nlayers=2)
    before = engine.master.clone()
    engine.train_batch(iter([batch]))
    assert engine.skipped_steps == 0 and engine.loss_scale == 2.0 ** 32
    moved = int((engine.master != before).sum())
    assert moved == int(sum(engine.segments.sizes))
