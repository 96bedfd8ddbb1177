"""ZeRO-Offload above one rank (``cpu_offload`` with the host state
sharded over the data ranks) against the JAX eager-offload engine and
against the port's own runs, on the CPU.

The port runs on one world of 4 gloo ranks
(:func:`tests.torch_offload_workers.offload_world`); the JAX engine in
this process on the same meshes of the conftest's virtual CPU devices,
while the ranks run.

- trajectories: 10 steps under ``cpu_offload`` at ZeRO-2 within
  ``RTOL`` of the JAX eager-offload engine (whose math is its step
  without offload) on ``{data: 2}`` (SimpleModel: Adam, Lamb, CPUAdam),
  ``{data: 2, model: 2}`` (GPT-2, a binding clip), ``{pipe: 2, data:
  2}`` (the linear pipeline) and ``{data: 2, seq: 2}`` (GPT-2 on the
  ring); every rank reports the same losses;
- each rank's host buffers hold its ``shard_rows`` rows, streamed in
  several chunks, and a gather of them (a checkpoint's) takes one
  all-gather a chunk of rows, never the whole buffer at once;
- bitwise: GPT-2 at dp 2 under offload and without it (Adam, Lamb; and
  Lamb at ``{data: 2, model: 2}``, whose trust ratios sum over the data
  rows and the model slices), ZeRO-3 and ZeRO-2 under offload,
  ``offload_gradients`` and offload alone, CPUAdam under offload and on
  the CPU engine's master without it, and the error-feedback host
  state (bf16 master and moments, fp32 residuals) at dp 2 and dp 1 with
  both ranks on the same rows;
- fp16 under the dynamic scaler: the JAX engine's skip and scale after
  every step;
- checkpoints: dp 2 into dp 1 and back, and the JAX engine's dp 2
  offload checkpoint into the port and the port's into it, master and
  moments bitwise;
- ``overlap_comm: true`` with ``cpu_offload`` raises as in the JAX
  engine.

The JAX engines run with one torch thread in this process, and every
rank on one thread (``run_ranks``): ATen's CPU elementwise kernels on
several threads round a chunk and the whole buffer apart in the last
bit (``tests/test_torch_offload.py``).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.models import GPT2Config as JConfig
from deepspeed_tpu.models import GPT2LMHeadTPU
from deepspeed_tpu.parallel import make_mesh as jax_mesh
from deepspeed_tpu.runtime.pipe import PipelineModule as JPipelineModule
from tests.unit.test_pipe import mse_loss as j_mse

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.parallel import Mesh

from . import torch_dp_workers as DP
from . import torch_offload_workers as W
from . import torch_pipe_workers as PIPE
from . import torch_seq_workers as SEQ
from . import torch_tp_workers as TP
from .test_torch_data_parallel import jax_engine as jax_dp_engine
from .test_torch_data_parallel import jax_state
from .test_torch_pipe import jax_linear_specs, jax_train, numpy_tree
from .test_torch_sequence_parallel import fresh_compiles, jax_gpt2
from .test_torch_tensor_parallel import jax_engine, jax_master
from .torch_dist import run_ranks

RTOL = 1e-5
# the whole master after 10 steps against the JAX engine's: the two
# engines sum the ranks' gradients in other orders, and Adam's step on a
# near-zero gradient carries the last bits up
MASTER_ATOL = 1e-4
JAX_OFFLOAD = {"stage": 2, "cpu_offload": True}


@pytest.fixture(autouse=True, scope="module")
def restore_jax_current_mesh():
    """The JAX engines make their mesh the JAX package's current mesh:
    put back the one this module found."""
    from deepspeed_tpu.parallel import mesh as jax_mesh_state

    prev = jax_mesh_state.get_current_mesh()
    yield
    jax_mesh_state.set_current_mesh(prev)


def jax_losses(eng, batches, steps=W.STEPS):
    it = iter(batches)
    return [float(np.asarray(eng.train_batch(it))) for _ in range(steps)]


def jax_references(lin):
    """The JAX eager-offload engine's runs of every trajectory case, and
    its fp16 trace."""
    out = {}
    for name, opt in W.DATA2_OPTIMIZERS:
        eng = jax_dp_engine("simple", DP.dp_config(
            2, opt, 1, 1.0, 2, zero_optimization=JAX_OFFLOAD))
        out[f"simple_{name}"] = {"losses": jax_losses(
            eng, DP.global_batches("simple", W.STEPS, 2)),
            "master": jax_state(eng)["master"]}
    eng = jax_dp_engine("simple", DP.dp_config(
        2, "Adam", 1, 0.0, 2, zero_optimization=JAX_OFFLOAD,
        fp16=dict(DP.FP16)))
    trace = {"losses": [], "scales": [], "skipped": []}
    for batch in DP.fp16_batches(2):
        trace["losses"].append(float(np.asarray(
            eng.train_batch(iter([batch])))))
        trace["scales"].append(float(eng.loss_scale))
        trace["skipped"].append(int(eng.skipped_steps))
    out["fp16"] = trace
    _, params = TP.gpt2()
    eng = jax_engine(GPT2LMHeadTPU(JConfig(**TP.TINY)), params,
                     TP.config(TP.ADAM, dp=2, **W.offload()),
                     {"data": 2, "model": 2})
    out["d2m2"] = {"losses": jax_losses(eng, TP.gpt2_batches(W.STEPS)),
                   "master": jax_master(eng)}
    mesh = jax_mesh({"pipe": 2, "data": 2}, devices=jax.devices("cpu")[:4])
    eng, *_ = jds.initialize(
        model=JPipelineModule(jax_linear_specs(), loss_fn=j_mse),
        config=PIPE.config(2, **W.offload()), mesh=mesh,
        model_parameters=jax.tree_util.tree_map(jnp.asarray, lin))
    out["p2d2"] = {"losses": jax_train(eng, PIPE.linear_data(), W.STEPS),
                   "master": eng.flat.gather_master_unpadded(
                       eng.state["master"])}
    _, params = SEQ.gpt2()
    with fresh_compiles():
        eng = jax_engine(jax_gpt2(), params,
                         SEQ.config(SEQ.ADAM, dp=2, **W.offload()),
                         {"data": 2, "seq": 2})
        out["d2s2"] = {"losses": jax_losses(eng,
                                            SEQ.gpt2_batches(W.STEPS)),
                       "master": jax_master(eng)}
    return out


def jax_offload_checkpoint(path):
    """The JAX eager-offload engine at ``{data: 2}`` (SimpleModel, Adam)
    after ``CKPT_STEPS`` steps, saved to ``path``; its state."""
    eng = jax_dp_engine("simple", DP.dp_config(
        2, "Adam", 1, 1.0, 2, zero_optimization=JAX_OFFLOAD))
    jax_losses(eng, DP.global_batches("simple", W.CKPT_STEPS, 2),
               W.CKPT_STEPS)
    eng.save_checkpoint(path, sync=True)
    eng.wait_checkpoint()
    return jax_state(eng)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results, the JAX references (made while the ranks
    run), the JAX checkpoint's state and the directory the ranks saved
    into."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        save_dir = str(tmp_path_factory.mktemp("offload_dp_ckpt"))
        jax_dir = str(tmp_path_factory.mktemp("offload_dp_jax"))
        jax_ckpt = jax_offload_checkpoint(jax_dir)
        lin = numpy_tree(JPipelineModule(jax_linear_specs(), loss_fn=j_mse)
                         .init(jax.random.PRNGKey(0)))
        got = {}

        def ranks():
            try:
                got["ranks"] = run_ranks(
                    W.offload_world, W.WORLD,
                    tmp_path_factory.mktemp("offload_dp"), save_dir,
                    jax_dir, lin)
            except BaseException as e:  # noqa: BLE001 - raised below
                got["error"] = e

        thread = threading.Thread(target=ranks)
        thread.start()
        try:
            ref = jax_references(lin)
        finally:
            thread.join()
        if "error" in got:
            raise got["error"]
    finally:
        torch.set_num_threads(n)
    return {"ranks": got["ranks"], "jax": ref, "jax_ckpt": jax_ckpt,
            "save_dir": save_dir}


def same_on_every_rank(ranks, key, field="losses"):
    got = [r[key][field] for r in ranks]
    for other in got[1:]:
        np.testing.assert_array_equal(other, got[0])
    return got[0]


def pair(run, key):
    """``key``'s results on the ``{data: 2}`` pair that ran it."""
    ranks = run["ranks"]
    return ranks[:2] if key in ranks[0] else ranks[2:]


TRAJECTORIES = [f"simple_{name}" for name, _ in W.DATA2_OPTIMIZERS] + [
    "d2m2", "p2d2", "d2s2"]


@pytest.mark.parametrize("key", TRAJECTORIES)
def test_ten_steps_match_the_jax_offload_engine(run, key):
    ranks = pair(run, key) if key.startswith("simple") else run["ranks"]
    got = same_on_every_rank(ranks, key)
    want = run["jax"][key]
    np.testing.assert_allclose(got, want["losses"], rtol=RTOL, atol=0)
    master = ranks[0][key]["master"]
    np.testing.assert_allclose(master, want["master"], rtol=0,
                               atol=MASTER_ATOL)


@pytest.mark.parametrize("key", ["gpt2_adam_offload", "gpt2_lamb_offload",
                                 "gpt2_offload_gradients", "ef_dp2", "d2m2",
                                 "p2d2", "d2s2"])
def test_host_buffers_hold_the_rank_rows(run, key):
    ranks = pair(run, key) if key in run["ranks"][0] \
        or key in run["ranks"][2] else run["ranks"]
    for r in ranks:
        host = r[key]["host"]
        assert host["shard_rows"] * 2 == host["rows"], host
        want = (host["shard_rows"], host["lanes"])
        assert set(host["shapes"].values()) == {want}, host
        assert host["chunks"] > 1 or key in ("gpt2_lamb_offload", "p2d2"), \
            host
    if key == "ef_dp2":
        assert {"res/master", "res/exp_avg",
                "res/exp_avg_sq"} <= set(ranks[0][key]["host"]["shapes"])
    if key == "gpt2_offload_gradients":
        assert "grad" in ranks[0][key]["host"]["shapes"]


def test_host_gather_takes_a_chunk_at_a_time(run):
    """A checkpoint's gather of the host master stages one chunk of every
    rank's rows at a time: ``W.GATHER_BYTES`` a collective, the whole
    buffer over all of them."""
    for r in pair(run, "gather_calls"):
        got = r["gather_calls"]
        rows = W.GATHER_BYTES // (2 * W.LANES * 4)
        assert got["calls"] == -(-got["shard_rows"] // rows) > 1, got
        assert got["bytes"] == got["shard_rows"] * 2 * W.LANES * 4, got


def assert_same_state(a, b, fields=("master", "exp_avg", "exp_avg_sq")):
    for f in fields:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert a["step"] == b["step"]


@pytest.mark.parametrize("got,want", [
    ("gpt2_adam_offload", "gpt2_adam_none"),
    ("gpt2_lamb_offload", "gpt2_lamb_none"),
    ("gpt2_offload_gradients", "gpt2_adam_offload"),
    ("simple_cpu_adam", "simple_cpu_adam_none"),
    ("gpt2_zero3_offload", "gpt2_adam_offload"),
    ("d2m2_lamb_offload", "d2m2_lamb_none")])
def test_offload_at_dp2_is_bitwise(run, got, want):
    ranks = run["ranks"] if got.startswith("d2m2") else run["ranks"][:2]
    for r in ranks:
        assert r[got]["losses"] == r[want]["losses"]
        assert_same_state(r[got], r[want])
    if got == "gpt2_zero3_offload":
        assert all(r[got]["freed"] for r in ranks)


def test_error_feedback_state_at_dp2_is_bitwise_dp1(run):
    """Both ranks of dp 2 on the same rows, no clip: the gradient is the
    dp 1 one's bits, so the bf16 master and moments and their fp32
    residuals are too."""
    for r in run["ranks"][2:]:
        dp2, dp1 = r["ef_dp2"], r["ef_dp1"]
        assert dp2["losses"] == dp1["losses"]
        assert_same_state(dp2, dp1)
        assert set(dp2["res"]) == {"master", "exp_avg", "exp_avg_sq"}
        for k in dp2["res"]:
            np.testing.assert_array_equal(dp2["res"][k], dp1["res"][k])
            assert np.abs(dp2["res"][k]).max() > 0


def test_fp16_skips_the_jax_engine_steps(run):
    want = run["jax"]["fp16"]
    for r in run["ranks"][2:]:
        got = r["fp16"]
        assert got["skipped"] == want["skipped"]
        assert got["scales"] == want["scales"]
    assert want["skipped"].index(1) == DP.POISON_STEP
    keep = [i for i in range(DP.STEPS) if i != DP.POISON_STEP]
    np.testing.assert_allclose(np.array(got["losses"])[keep],
                               np.array(want["losses"])[keep], rtol=1e-2)


@pytest.mark.parametrize("saved,loaded", [("ckpt_dp2", "ckpt_dp2_at_dp1"),
                                          ("ckpt_dp1", "ckpt_dp1_at_dp2")])
def test_checkpoints_cross_degrees_bitwise(run, saved, loaded):
    for r in run["ranks"][2:]:
        assert_same_state(r[loaded], run["ranks"][2][saved])


def test_jax_offload_checkpoint_loads_bitwise(run):
    for r in run["ranks"][2:]:
        assert_same_state(r["from_jax"], run["jax_ckpt"])


def test_port_offload_checkpoint_loads_into_jax_bitwise(run):
    eng = jax_dp_engine("simple", DP.dp_config(
        2, "Adam", 1, 1.0, 2, zero_optimization=JAX_OFFLOAD))
    eng.load_checkpoint(f"{run['save_dir']}/for_jax")
    assert_same_state(jax_state(eng), run["ranks"][2]["for_jax"])


def test_overlap_comm_with_offload_raises_as_in_jax():
    """The bucketed exchange's refusal comes before any collective, in
    both engines."""
    cfg = DP.dp_config(2, "Adam", 1, 1.0, 2, zero_optimization=dict(
        JAX_OFFLOAD, overlap_comm=True))
    model, params = DP.model_and_params("simple")
    with pytest.raises(ValueError, match="cpu_offload") as ours:
        tds.initialize(model=model, model_parameters=params, config=cfg,
                       mesh=Mesh({"data": 2}), device="cpu")
    with pytest.raises(ValueError, match="cpu_offload") as theirs:
        jax_dp_engine("simple", cfg)
    assert "bucketed exchange" in str(ours.value)
    assert "bucketed exchange" in str(theirs.value)
