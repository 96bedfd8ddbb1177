"""ZeRO-Offload at one rank (``zero_optimization.cpu_offload``) against
the JAX package and against the port's own run without it, on the CPU.

- config: the JAX ``test_config_validation`` inputs
  (``tests/unit/test_offload_state_dtype.py:73``) raise, or pass, alike
  in both packages, with the same error class naming the same key;
- the streamed update (``runtime/zero/stream.py``) equals JAX's
  ``uniform_scan_update`` on the same state at the optimizer parity
  tolerance (atol = rtol = 1e-6, ``test_torch_optimizers.py``); chunk
  sizes (one chunk, 1 MB, a ragged last chunk) and prefetch depths 1, 2
  and 3 give the same result bit for bit (SR state: every depth, at one
  chunk size); an overflow step moves no state;
- the engine: 10 steps of SimpleModel and of a 2-layer GPT-2 under
  offload match the JAX eager-offload engine at dp = 1 at rtol 1e-5
  (``test_torch_engine.py``'s trajectory tolerance); offload is bitwise
  the port's run without it in fp32 and bf16 compute, with Lamb (the
  one-shot update) too, and under fp16 it skips the same steps;
  ``offload_group_mb`` and ``offload_uniform_chunks`` change nothing;
- reduced-precision state: SR and EF over 200 steps track the JAX fp32
  curve at rtol 2e-2 / atol 2e-3 with falling losses (the JAX tests'
  bound, ``test_offload_state_dtype.py:137``, ``:148``), and nearest
  rounding drifts (``test_mechanism_is_load_bearing``);
- checkpoints: a JAX eager-offload checkpoint loads into the port's
  offload engine bitwise and back, an EF checkpoint keeps its residuals
  bitwise, and folds into an fp32 engine; a guard rollback under
  offload matches a clean run bitwise.

Every test runs on one intra-op thread: ATen's CPU elementwise kernels
split a tensor among threads at sizes that depend on its length, and
the scalar tail of each part rounds ``a + alpha * b`` twice where the
vector body fuses it, so a chunk and the whole buffer can differ in the
last bit on several threads; and the parity with JAX at 1e-5 keeps
clear of the first-``exp`` flake of ROADMAP C1.  On the card every
element takes one code path, and chip_smoke phase 26 holds GPT-2-medium
to the bitwise contract there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.models import GPT2Config as JConfig
from deepspeed_tpu.models import GPT2LMHeadTPU
from deepspeed_tpu.ops.adam.fused_adam import FusedAdam as JAdam
from deepspeed_tpu.parallel import make_mesh
from deepspeed_tpu.runtime.zero import stream as jstream
from deepspeed_tpu.runtime.zero.config import DeepSpeedZeroConfig as JZero

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params
from deepspeed_tpu_torch.ops.adam.fused_adam import AdamState, FusedAdam
from deepspeed_tpu_torch.ops.op_common import LANES
from deepspeed_tpu_torch.resilience.chaos import ChaosMonkey
from deepspeed_tpu_torch.runtime.zero import qstate, stream
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig

from .torch_simple_model import SimpleModel, base_config, random_batches
from .unit.simple_model import SimpleModel as JSimpleModel

TRAJ_RTOL = 1e-5
STATE_TOL = 1e-6
TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=64, embd_dropout=0.0, attn_dropout=0.0,
            resid_dropout=0.0)
OFFLOAD = {"stage": 2, "cpu_offload": True, "offload_chunk_mb": 1}
BF16_SR = "bf16"
BF16_EF = {"momentum": "bf16", "variance": "bf16", "master": "bf16",
           "error_feedback": True}
BF16_NEAREST = {"momentum": "bf16", "variance": "bf16", "master": "bf16",
                "rounding": "nearest"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh():
    return make_mesh({"data": 1}, devices=jax.devices("cpu")[:1])


# ------------------------------------------------------------- config
def zero_configs():
    def zc(sub, cpu_offload=True):
        return {"zero_optimization": {"stage": 2, "cpu_offload": cpu_offload,
                                      "offload_state_dtype": sub}}

    return [zc({"momentum": "int8"}), zc({"master": "fp16"}),
            zc({"momentum": "bf16", "rounding": "sideways"}),
            zc({"momentum": "bf16", "error_feedback": "yes"}),
            zc("bf16", cpu_offload=False), zc("bf16"), zc("fp16"),
            zc(BF16_EF), zc({"seed": 1.5}), zc(7),
            {"zero_optimization": {"stage": 2, "offload_overlap": True}},
            {"zero_optimization": {"stage": 2, "cpu_offload": True,
                                   "offload_prefetch_depth": 0}},
            {"zero_optimization": {"stage": 2, "cpu_offload": True,
                                   "offload_uniform_chunks": 0}},
            {"zero_optimization": {"stage": 2, "cpu_offload": True,
                                   "offload_group_mb": 3585}},
            {"zero_optimization": {"stage": 2, "offload_gradients": True}}]


@pytest.mark.parametrize("d", zero_configs(),
                         ids=[f"zc{i}" for i in range(len(zero_configs()))])
def test_config_validation_matches_jax(d):
    """The same error class, its message naming the same key; or the
    same parse."""
    def parse(cls):
        try:
            return cls(d), None
        except Exception as e:  # noqa: BLE001 - compared below
            return None, e

    theirs, their_err = parse(JZero)
    ours, our_err = parse(DeepSpeedZeroConfig)
    if their_err is not None:
        assert type(our_err) is type(their_err), (our_err, their_err)
        key = str(their_err).split()[0]
        assert str(our_err).split()[0] == key, (our_err, their_err)
        return
    assert our_err is None, our_err
    assert ours.offload_state_dtype == theirs.offload_state_dtype
    assert ours.offload_state_reduced == theirs.offload_state_reduced
    assert (ours.offload_state_residual_count
            == theirs.offload_state_residual_count)


# ------------------------------------------------------------- stream
def adam_chunk(opt, state, g, hp, quant=None):
    """The engine's chunk function on plain buffers: the optimizer's own
    update on the chunk views, then the quantized store."""
    def fn(k, r0, rc, v):
        pm = quant.load(v["master"]) if quant else v["master"]
        leaves = {f: quant.load(v[f]) if quant else v[f]
                  for f in ("exp_avg", "exp_avg_sq")}
        st = AdamState(step=state.step, **leaves)
        opt.update(st, pm, g[r0:r0 + rc], hp)
        if quant is not None:
            for slot, name in enumerate(("master", "exp_avg", "exp_avg_sq")):
                val = pm if name == "master" else getattr(st, name)
                q, _ = quant.store(val, quant.dtype_of(name),
                                   step=state.step + 1, tag=k,
                                   slot=slot)
                v[name].copy_(q)
    return fn


def run_stream(rows, chunk_rows, depth, master, g, steps=3, quant=None):
    opt = FusedAdam(lr=1e-3, weight_decay=0.01)
    hp = opt.hyperparams()
    dt = quant.master_dtype if quant else torch.float32
    mdt = quant.dtype_of("exp_avg") if quant else torch.float32
    # a copy: the stream writes its host buffers in place, and the JAX
    # side may read the same numpy array asynchronously
    host = {"master": torch.tensor(master, dtype=dt),
            "exp_avg": torch.zeros(rows, LANES, dtype=mdt),
            "exp_avg_sq": torch.zeros(rows, LANES, dtype=mdt)}
    s = stream.HostStream(rows, chunk_rows, depth, "cpu")
    state = AdamState(exp_avg=None, exp_avg_sq=None, step=0)
    for _ in range(steps):
        s.run(host, adam_chunk(opt, state, torch.from_numpy(g), hp, quant),
              writes=tuple(host))
        state.step += 1
    return host, s


def test_streamed_update_matches_the_jax_scan_update():
    chunk_rows, rows = 8, 32
    rng = np.random.default_rng(0)
    master = rng.normal(size=(rows, LANES)).astype(np.float32)
    g = rng.normal(size=(rows, LANES)).astype(np.float32)
    jopt = JAdam(lr=1e-3, weight_decay=0.01)
    st0 = jopt.init_state(jnp.asarray(master))
    leaves, treedef = jax.tree_util.tree_flatten(st0)
    is_flat = [getattr(x, "ndim", 0) == 2 for x in leaves]
    new_m, new_gl, _ = jstream.uniform_scan_update(
        masters=[jnp.asarray(master)], group_leaves=[list(leaves)],
        is_flat=is_flat, opt_treedef=treedef, update_fn=jopt.update,
        hp=jopt.hyperparams(), overflow=jnp.asarray(False), skip_bad=False,
        jobs=jstream.uniform_chunk_jobs(((0, rows),), chunk_rows),
        chunk_rows=chunk_rows, lanes=LANES, g=jnp.asarray(g))
    host, s = run_stream(rows, chunk_rows, 2, master, g, steps=1)
    assert s.schedule() == {"overlap": True, "prefetch_depth": 2,
                            "chunks": 4, "groups": 1, "form": "loop"}
    np.testing.assert_allclose(host["master"].numpy(), np.asarray(new_m[0]),
                               rtol=STATE_TOL, atol=STATE_TOL)
    for i, name in enumerate(("exp_avg", "exp_avg_sq")):
        np.testing.assert_allclose(host[name].numpy(),
                                   np.asarray(new_gl[0][i]),
                                   rtol=STATE_TOL, atol=STATE_TOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "sr"])
def test_chunks_and_depths_are_bitwise_the_same(quantized):
    """One chunk, 1 MB chunks, chunks of 3 rows (the last ragged) at
    depths 1, 2 and 3: the same bits.  SR state draws its bits per chunk
    (the tag is the job's index, its rank by row as JAX's
    ``sr_chunk_tags`` ranks it), so there every depth gives the same
    bits at one chunk size, as in the JAX package."""
    rows = 10
    rng = np.random.default_rng(1)
    master = rng.normal(size=(rows, LANES)).astype(np.float32)
    g = rng.normal(size=(rows, LANES)).astype(np.float32)
    quant = (qstate.build_state_quant({"master": "bf16", "momentum": "bf16",
                                       "variance": "bf16"},
                                      [("exp_avg", True),
                                       ("exp_avg_sq", True),
                                       ("step", False)])
             if quantized else None)
    assert stream.split_rows(rows, 3) == ((0, 3), (3, 3), (6, 3), (9, 1))
    assert stream.chunk_rows_for(1) == 256 and stream.chunk_rows_for(0) is None
    ref, _ = run_stream(rows, None, 1, master, g, quant=quant)
    for chunk_rows in (stream.chunk_rows_for(1), 3):
        if quantized:
            ref, _ = run_stream(rows, chunk_rows, 1, master, g, quant=quant)
        for depth in (1, 2, 3):
            got, s = run_stream(rows, chunk_rows, depth, master, g,
                                quant=quant)
            assert s.depth == min(depth, len(s.jobs))
            for name in ref:
                assert torch.equal(got[name], ref[name]), (chunk_rows,
                                                            depth, name)
    jobs = [(0, r0, r0) for r0, _ in stream.split_rows(rows, 3)]
    assert jstream.sr_chunk_tags(jobs) == list(range(len(jobs)))


# ------------------------------------------------------------- engines
def gpt2_batches(n, micro=2, seq=32, seed=1):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, size=(micro, seq))
             .astype(np.int32)} for _ in range(n)]


def gpt2_config(zero, opt="Adam", clip=1.0, **extra):
    return dict({"train_batch_size": 2, "steps_per_print": 10 ** 9,
                 "gradient_clipping": clip,
                 "optimizer": {"type": opt, "params": {"lr": 3e-3}},
                 "zero_optimization": zero}, **extra)


def gpt2_engine(config, params):
    engine, *_ = tds.initialize(model=GPT2LMHead(GPT2Config(**TINY)),
                                model_parameters=params, config=config,
                                device="cpu")
    return engine


def gpt2_run(config, steps=10, params=None, after=None):
    params = random_params(GPT2Config(**TINY), 0) if params is None \
        else params
    engine = gpt2_engine(config, params)
    out = []
    for batch in gpt2_batches(steps):
        out.append(float(engine.train_batch(iter([batch]))))
        if after is not None:
            after(engine)
    return out, engine


def simple_engine(zero, hidden=16, nlayers=2, **kw):
    model = SimpleModel(hidden, nlayers=nlayers)
    engine, *_ = tds.initialize(
        model=model, model_parameters=model.init(0),
        config=base_config(zero_optimization=zero, **kw), device="cpu")
    return engine


def simple_losses(engine, steps, hidden=16):
    batch = random_batches(1, 16, hidden, seed=0)[0]
    return np.array([float(engine.train_batch(iter([batch])))
                     for _ in range(steps)])


def jax_simple_losses(zero, steps, hidden=16, nlayers=2):
    params = SimpleModel(hidden, nlayers=nlayers).init(0)
    engine, *_ = jds.initialize(
        model=JSimpleModel(hidden, nlayers=nlayers),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, params),
        config=base_config(zero_optimization=zero), mesh=cpu_mesh())
    batch = random_batches(1, 16, hidden, seed=0)[0]
    return np.array([float(np.asarray(engine.train_batch(iter([batch]))))
                     for _ in range(steps)])


@pytest.mark.parametrize("model", ["simple", "gpt2"])
def test_ten_steps_match_the_jax_offload_engine(model):
    jzero = {"stage": 2, "cpu_offload": True}
    if model == "simple":
        want = jax_simple_losses(jzero, 10)
        got = simple_losses(simple_engine(OFFLOAD), 10)
    else:
        params = random_params(GPT2Config(**TINY), 0)
        jengine, *_ = jds.initialize(
            model=GPT2LMHeadTPU(JConfig(**TINY)),
            model_parameters=jax.tree_util.tree_map(jnp.asarray, params),
            config=gpt2_config(jzero), mesh=cpu_mesh())
        want = [float(jengine.train_batch(iter([b])))
                for b in gpt2_batches(10)]
        got, engine = gpt2_run(gpt2_config(OFFLOAD), params=params)
        assert engine.host_stream_schedule()["chunks"] >= 1
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL, atol=0)


def masters(trace):
    return lambda e: trace.append(e.get_master_params()["wte"].clone())


@pytest.mark.parametrize("opt,bf16", [("Adam", False), ("Adam", True),
                                      ("Lamb", False), ("Lamb", True)])
def test_offload_is_bitwise_the_run_without_it(opt, bf16):
    extra = {"bf16": {"enabled": True}} if bf16 else {}
    base, trace_b = [], []
    base, eb = gpt2_run(gpt2_config({"stage": 2}, opt, **extra),
                        after=masters(trace_b))
    trace_o = []
    off, eo = gpt2_run(gpt2_config(OFFLOAD, opt, **extra),
                       after=masters(trace_o))
    assert off == base
    assert all(torch.equal(a, b) for a, b in zip(trace_o, trace_b))
    assert torch.equal(eo._compute, eb._compute)
    assert eo.master.device.type == "cpu" and eo.master is not eb.master
    assert torch.equal(eo.master, eb.master)
    if opt == "Adam":
        assert eo.host_stream_schedule()["form"] == "loop"
    else:
        assert eo.host_stream_schedule() is None  # the one-shot update


@pytest.mark.parametrize("key,values", [
    ("offload_group_mb", (1, 512, 3584)),
    ("offload_uniform_chunks", (True, False, "auto")),
    ("offload_prefetch_depth", (1, 3)),
    ("offload_chunk_mb", (0, 2))])
def test_keys_change_nothing_but_the_schedule(key, values):
    ref = simple_losses(simple_engine(OFFLOAD, hidden=64), 5, hidden=64)
    for val in values:
        engine = simple_engine(dict(OFFLOAD, **{key: val}), hidden=64)
        np.testing.assert_array_equal(
            simple_losses(engine, 5, hidden=64), ref)


def test_fp16_under_offload_skips_the_same_steps():
    """fp16 from the default scale 2^32: the early steps overflow and
    are skipped alike; a skipped step moves no host state and re-casts
    the compute params from the master, so a poisoned compute param
    heals as it does without offload."""
    fp16 = {"fp16": {"enabled": True, "initial_scale_power": 32}}
    runs = {}
    for name, zero in (("off", {"stage": 2}), ("on", OFFLOAD)):
        trace = []

        def after(e, trace=trace):
            trace.append((e.skipped_steps, e.loss_scale))

        runs[name] = gpt2_run(gpt2_config(zero, clip=0.0, **fp16),
                              after=after) + (trace,)
    assert runs["on"][0] == runs["off"][0]
    assert runs["on"][2] == runs["off"][2]
    assert runs["on"][2][-1][0] > 0  # steps were skipped
    computes = {}
    for name, (_, engine, _) in runs.items():
        before = [t.clone() for t in (engine.master, engine.opt_state.exp_avg,
                                      engine._compute)]
        with torch.no_grad():
            engine.params["wte"].fill_(float("nan"))
        engine._grad.fill_(float("inf"))
        engine._losses = [torch.tensor(1.0)]
        engine.micro_steps += 1
        engine.step()
        after = (engine.master, engine.opt_state.exp_avg, engine._compute)
        assert all(torch.equal(a, b) for a, b in zip(before, after)), name
        computes[name] = engine._compute
    assert torch.equal(computes["on"], computes["off"])


# ------------------------------------------------------------ qstate
@pytest.fixture(scope="module")
def fp32_curve():
    """The JAX fp32 engine's 220-step curve (SimpleModel 64 x 2)."""
    return jax_simple_losses({"stage": 2}, 220, hidden=64)


@pytest.mark.parametrize("layout", ["sr", "ef"])
def test_reduced_state_tracks_the_jax_fp32_curve(fp32_curve, layout):
    sd = BF16_SR if layout == "sr" else BF16_EF
    engine = simple_engine(dict(OFFLOAD, offload_state_dtype=sd),
                           hidden=64)
    assert engine.master.dtype == torch.bfloat16
    assert engine.opt_state.exp_avg_sq.dtype == torch.bfloat16
    losses = simple_losses(engine, 200, hidden=64)
    np.testing.assert_allclose(losses, fp32_curve[:200], rtol=2e-2,
                               atol=2e-3)
    assert losses[-1] < losses[0]
    if layout == "ef":
        assert set(engine._qres) == {"master", "exp_avg", "exp_avg_sq"}
        assert all(float(b.float().abs().sum()) > 0
                   for b in engine._qres.values())
        assert (engine.host_state_bytes_per_step()
                == 2 * engine.segments.rows * LANES * 4 * 3)
    else:
        assert not engine._qres
        assert (engine.host_state_bytes_per_step()
                == engine.segments.rows * LANES * 4 * 3)


def test_nearest_rounding_drifts(fp32_curve):
    """The mechanism carries the accuracy, not the dtype: nearest
    rounding with no residual drifts from the JAX fp32 curve where SR
    and EF stay on it (the JAX test's margins)."""
    steps = 220

    def tail_dev(sd):
        x = simple_losses(simple_engine(dict(OFFLOAD, offload_state_dtype=sd),
                                        hidden=64), steps, hidden=64)
        d = np.abs(x - fp32_curve) / np.maximum(np.abs(fp32_curve), 1e-8)
        return float(d[-50:].mean())

    dev_sr, dev_ef, dev_nr = (tail_dev(sd) for sd in
                              (BF16_SR, BF16_EF, BF16_NEAREST))
    assert dev_nr > 5e-4, (dev_nr, "the control did not drift")
    assert dev_nr > 3 * dev_sr, (dev_nr, dev_sr)
    assert dev_nr > 3 * dev_ef, (dev_nr, dev_ef)


# -------------------------------------------------------- checkpoints
def flat_state(engine):
    engine._sync_host()
    out = {"master": engine.master.float().clone()}
    out.update({f: getattr(engine.opt_state, f).float().clone()
                for f in ("exp_avg", "exp_avg_sq")})
    out.update({f"res/{k}": v.clone() for k, v in engine._qres.items()})
    return out


def test_jax_offload_checkpoint_loads_bitwise_and_back(tmp_path):
    jzero = {"stage": 2, "cpu_offload": True}
    params = random_params(GPT2Config(**TINY), 0)
    jengine, *_ = jds.initialize(
        model=GPT2LMHeadTPU(JConfig(**TINY)),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, params),
        config=gpt2_config(jzero), mesh=cpu_mesh())
    for b in gpt2_batches(3):
        jengine.train_batch(iter([b]))
    jengine.save_checkpoint(str(tmp_path / "jax"), sync=True)
    engine = gpt2_engine(gpt2_config(OFFLOAD), params)
    engine.load_checkpoint(str(tmp_path / "jax"), strict=True)
    assert engine.global_steps == 3 and engine.opt_state.step == 3
    np.testing.assert_array_equal(
        engine.flat.gather_master_unpadded(engine.master),
        jengine.flat.gather_master_unpadded(jengine.state["master"]))
    # the params are the master's cast, sent up from the host
    want = engine.master.to(engine.compute_dtype)
    assert torch.equal(engine._compute, want)
    engine.save_checkpoint(str(tmp_path / "port"), sync=True)
    jengine2, *_ = jds.initialize(
        model=GPT2LMHeadTPU(JConfig(**TINY)),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, params),
        config=gpt2_config(jzero), mesh=cpu_mesh())
    jengine2.load_checkpoint(str(tmp_path / "port"))
    for key in ("master",):
        np.testing.assert_array_equal(
            jengine2.flat.gather_master_unpadded(jengine2.state[key]),
            jengine.flat.gather_master_unpadded(jengine.state[key]))
    nxt = gpt2_batches(4)[3]
    np.testing.assert_allclose(float(engine.train_batch(iter([nxt]))),
                               float(jengine2.train_batch(iter([nxt]))),
                               rtol=TRAJ_RTOL)


def test_ef_checkpoint_keeps_its_residuals_and_folds_elsewhere(tmp_path):
    zero = dict(OFFLOAD, offload_state_dtype=BF16_EF)
    engine = simple_engine(zero, hidden=64)
    simple_losses(engine, 5, hidden=64)
    engine.save_checkpoint(str(tmp_path), sync=True)
    saved = flat_state(engine)
    tail = simple_losses(engine, 3, hidden=64)
    # the same layout: every buffer and residual bitwise, and the resumed
    # steps bitwise the uninterrupted ones
    same = simple_engine(zero, hidden=64)
    same.load_checkpoint(str(tmp_path), strict=True)
    got = flat_state(same)
    assert set(got) == set(saved)
    assert all(torch.equal(got[k], saved[k]) for k in saved)
    np.testing.assert_array_equal(simple_losses(same, 3, hidden=64), tail)
    # an fp32 engine folds each residual into its value
    fp32 = simple_engine(OFFLOAD, hidden=64)
    fp32.load_checkpoint(str(tmp_path), strict=True)
    folded = flat_state(fp32)
    for name in ("master", "exp_avg", "exp_avg_sq"):
        want = saved[name] + saved[f"res/{name}"].float()
        assert torch.equal(folded[name], want), name
    # an EF engine loading an fp32 checkpoint keeps the rounding error
    fp32.save_checkpoint(str(tmp_path / "fp32"), sync=True)
    ef = simple_engine(zero, hidden=64)
    ef.load_checkpoint(str(tmp_path / "fp32"), strict=True)
    res = flat_state(ef)
    for name in ("master", "exp_avg", "exp_avg_sq"):
        val = folded[name]
        assert torch.equal(res[name], val.to(torch.bfloat16).float())
        assert torch.equal(res[f"res/{name}"],
                           (val - val.to(torch.bfloat16).float())
                           .to(torch.bfloat16))


def test_guard_rollback_under_offload_matches_a_clean_run(tmp_path):
    """Two NaN batches in a row are two anomalies; the guard rolls back
    to the committed checkpoint, and the run then equals a clean one
    resumed from it, bitwise."""
    resilience = {"resilience": {
        "enabled": True, "policy": "rollback", "divergence_patience": 2,
        "checkpoint_dir": str(tmp_path), "spike_window": 0}}
    zero = dict(OFFLOAD)
    engine = simple_engine(zero, **resilience)
    clean = simple_engine(zero)
    batch = random_batches(1, 16, 16, seed=0)[0]
    for e in (engine, clean):
        for _ in range(3):
            e.train_batch(iter([batch]))
    engine.save_checkpoint(str(tmp_path), sync=True)
    for _ in range(2):
        engine.train_batch(iter([ChaosMonkey.nan_batch(batch)]))
    assert engine.global_steps == 3 and engine._rollback_mgr.rollbacks_used == 1
    got = [float(engine.train_batch(iter([batch]))) for _ in range(3)]
    want = [float(clean.train_batch(iter([batch]))) for _ in range(3)]
    assert got == want
    assert torch.equal(engine.master, clean.master)


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("zero,opt,acc,match", [
    (dict(OFFLOAD, offload_gradients=True), "Lamb", 1, "flat Adam"),
    (dict(OFFLOAD, offload_gradients=True), "Adam", 2,
     "gradient_accumulation_steps"),
    (dict(OFFLOAD, offload_state_dtype="bf16"), "Lamb", 1, "flat Adam"),
    (dict(OFFLOAD, offload_overlap=True, offload_prefetch_depth=1), "Adam",
     1, "serialized")])
def test_meaningful_refusals_stay(zero, opt, acc, match):
    config = base_config(
        zero_optimization=zero, gradient_accumulation_steps=acc,
        optimizer={"type": opt, "params": {"lr": 0.01}})
    with pytest.raises(ValueError, match=match):
        tds.initialize(model=SimpleModel(16, nlayers=2), config=config,
                       device="cpu")


def test_offload_gradients_trains_through_train_batch_only():
    base = simple_losses(simple_engine({"stage": 2}), 4)
    engine = simple_engine(dict(OFFLOAD, offload_gradients=True))
    assert engine._host_grad.dtype == torch.float32
    np.testing.assert_array_equal(simple_losses(engine, 4), base)
    batch = random_batches(1, 16, 16, seed=0)[0]
    with pytest.raises(RuntimeError, match="train_batch"):
        engine.forward(batch)
