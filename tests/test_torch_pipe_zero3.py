"""ZeRO-3 and 1-bit Adam under the pipeline engine (ROADMAP A13's
remainder) against the JAX ``PipelineEngine`` on the same mesh.

Four gloo ranks at ``{pipe: 2, data: 2}``
(:func:`tests.torch_pipe_workers.zero3_onebit_world`, spawned once),
the JAX engine on the same mesh over four virtual CPU devices, the
weights the JAX modules draw (``tests/test_torch_pipe.py``).

ZeRO-3: each stage's master is partitioned over its data group; the
stage's compute params are gathered before a forward or backward that
finds them freed and freed when no micro-batch is in flight.
- The linear stack (each micro-batch's gradient reduce-scattered at
  once) and the tied GPT-like stack with a binding clip (the tied
  copies summed over their stages before the step's reduce-scatter):
  losses within ``RTOL`` of the JAX engine's ZeRO-3 runs, and bitwise
  the port's own ZeRO-2 runs, losses and masters;
- between steps a stage holds no compute params, and its master is its
  data rank's rows;
- the checkpoint is the whole tree: the JAX engine loads it and its
  evaluation loss is the port's.

1-bit Adam (stage 0, ``freeze_step`` 3): each stage compresses its
momentum over its data group after the tied copies' sum, with the
compression's scales over both stages (a tied param counted once).  The
JAX ``PipelineEngine`` steps through the step-wise ``step()``, whose
program is the dense one at every step (ROADMAP C3): it never enters
the compressed phase.  So the warmup, and the first loss after the
freeze (the warmup's master), are held to it within ``RTOL``, and the
compressed steps only to ``COMPRESSED_RTOL`` of its dense steps
(measured); the compressed phase is held to its own contract: no dense
all-reduce, one all-to-all of packed signs a step, error buffers sized
for the stage's own flat, and the tied copies bitwise equal on both
stages and the masters on both data ranks.
"""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.comm import compression

from . import torch_pipe_workers as W
from .test_torch_pipe import jax_run, weights  # noqa: F401
from .torch_dist import run_ranks

TOPO = {"pipe": 2, "data": 2}
RTOL = 2e-5
# the port's compressed steps against the JAX engine's dense ones at
# the same lr, Adam's eps 1e-3: measured 6.6e-5 and 1.4e-4 after the
# first and second compressed updates
COMPRESSED_RTOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):   # noqa: F811
    save_dir = str(tmp_path_factory.mktemp("zero3_ckpt"))
    out = {"save_dir": save_dir}
    for kind in ("lin", "gpt"):
        extra = ({} if kind == "lin" else
                 {"gradient_clipping": W.CLIP, "optimizer": W.CLIP_ADAM})
        _, out[f"jax_{kind}"] = jax_run(kind, TOPO, weights, dp=2,
                                        zero_optimization={"stage": 3},
                                        **extra)
    _, out["jax_onebit"] = jax_run("gpt", TOPO, weights,
                                   steps=W.ONEBIT_STEPS, dp=2,
                                   zero_optimization={"stage": 0},
                                   optimizer=W.ONEBIT)
    out["ranks"] = run_ranks(W.zero3_onebit_world, 4,
                             tmp_path_factory.mktemp("ranks"),
                             weights["lin"], weights["gpt"], save_dir)
    return out


@pytest.mark.parametrize("kind", ["lin", "tied"])
def test_zero3_under_pipe2_data2_matches_the_jax_engine(runs, kind):
    want = runs["jax_lin" if kind == "lin" else "jax_gpt"]
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[f"{kind}_z3"]["losses"], want,
                                   rtol=RTOL, atol=0)


@pytest.mark.parametrize("kind", ["lin", "tied"])
def test_zero3_under_a_pipe_is_bitwise_zero2(runs, kind):
    for r in runs["ranks"]:
        assert r[f"{kind}_z3"]["losses"] == r[f"{kind}_z2"]["losses"]
        np.testing.assert_array_equal(r[f"{kind}_z3"]["master"],
                                      r[f"{kind}_z2"]["master"])


def test_zero3_stage_holds_no_compute_params_between_steps(runs):
    """Ranks 0-1 are stage 0's data ranks, 2-3 stage 1's; the tied
    stack's stages hold a tied copy, so they exchange at the step."""
    for r in runs["ranks"]:
        got = r["tied_z3"]
        assert got["defer"]
        assert got["compute_bytes"] == 0
        assert got["shard_rows"] * 2 == got["stage_rows"]


def test_zero3_pipe_checkpoint_loads_in_the_jax_engine(runs, weights):  # noqa: F811,E501
    """The JAX engine at one stage loads the whole tree the ZeRO-3 stages
    wrote, and its evaluation loss on the same micro-batches is the
    port's."""
    engine, _ = jax_run("gpt", {"data": 1}, weights, steps=0)
    engine.load_checkpoint(runs["save_dir"])
    loss = float(np.asarray(jax.device_get(engine.eval_batch(
        iter(W.token_data())))))
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["tied_z3"]["eval"], loss, rtol=RTOL)


def test_onebit_under_pipe2_data2_against_the_jax_engine(runs):
    want = runs["jax_onebit"]
    got = runs["ranks"][0]["onebit"]["losses"]
    for r in runs["ranks"][1:]:
        assert r["onebit"]["losses"] == got
    k = W.ONEBIT["params"]["freeze_step"] + 1
    np.testing.assert_allclose(got[:k], want[:k], rtol=RTOL, atol=0)
    np.testing.assert_allclose(got, want, rtol=COMPRESSED_RTOL, atol=0)


def test_onebit_under_a_pipe_keeps_its_copies_equal(runs):
    """The tied copies on stage 0 (ranks 0, 1) and stage 1 (ranks 2, 3)
    bitwise equal after the compressed steps, and each stage's master
    equal on its two data ranks."""
    ranks = [r["onebit"] for r in runs["ranks"]]
    assert set(ranks[0]["tied"]) == set(ranks[2]["tied"]) == {"emb"}
    np.testing.assert_array_equal(ranks[0]["tied"]["emb"],
                                  ranks[2]["tied"]["emb"])
    for a, b in ((0, 1), (2, 3)):
        np.testing.assert_array_equal(ranks[a]["master"], ranks[b]["master"])


def test_onebit_under_a_pipe_exchanges_signs_per_stage(runs):
    freeze = W.ONEBIT["params"]["freeze_step"]
    for r in runs["ranks"]:
        got = r["onebit"]
        n = got["n_local"]
        n_pad = compression.padded_size(n, 2)
        assert got["errors"] == ((n_pad,), (n_pad // 2,))
        warm = got["calls"][freeze - 1][1]["psum"]
        for step, (calls, nbytes) in enumerate(got["calls"]):
            if step < freeze:
                assert "all_to_all" not in calls
                assert nbytes["psum"] >= 4 * n
                continue
            assert calls["all_to_all"] == 1
            assert nbytes["all_to_all"] <= n_pad // 8
            assert nbytes["psum"] <= warm - 4 * n + 64, (step, nbytes)
