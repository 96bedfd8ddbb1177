"""DeepSpeedCPUAdam's host kernel (``csrc/adam/cpu_adam.cpp``, built by
the op builder with g++) against the JAX package's.

- the port's library, run in place, is bitwise the JAX ``_host_adam``
  (its own build of the same source with the same flags, out of place)
  on the same arrays, in AdamW and L2 modes;
- the optimizer is within the JAX test's tolerance of the plain version
  (FusedAdam's arithmetic) over 4 steps: rtol 2e-6, atol 1e-7 on the
  params (``tests/unit/test_cpu_adam.py:37-41``);
- the engine on CPUAdam, with and without ``cpu_offload``, matches the
  JAX CPUAdam engine (``tests/unit/test_cpu_adam.py:57``) at rtol 1e-5;
- the build keys on its source and flags, raises with g++'s stderr, and
  the kernel refuses what is not a contiguous fp32 host tensor;
- g++ vectorizes the update loop with the build's flags (its
  ``-fopt-info-vec-optimized`` report names the loop's line), and the
  kernel is bitwise the JAX build on one thread and on several;
- the OpenMP team is the host's CPUs split over the ranks that share the
  host (``LOCAL_WORLD_SIZE``), a pinned rank's own CPUs, and OpenMP's
  own choice for one rank or a team set in ``OMP_NUM_THREADS``.
"""

import re
import subprocess

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.ops.adam.cpu_adam import _host_adam
from deepspeed_tpu.parallel import make_mesh
from .unit.simple_model import SimpleModel as JSimpleModel

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.adam import cpu_adam
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from .torch_simple_model import SimpleModel, base_config, \
    random_batches

HIDDEN = 16


@pytest.fixture
def one_thread():
    """The engine parity at 1e-5 on one intra-op thread (ROADMAP C1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def arrays(n, seed):
    rng = np.random.default_rng(seed)
    p, m, g = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    v = np.abs(rng.normal(size=n)).astype(np.float32)
    return p, m, v, g


@pytest.mark.parametrize("adamw", [1, 0], ids=["adamw", "l2"])
@pytest.mark.parametrize("n", [1, 1000, 64 * 1024 + 3])
def test_kernel_is_bitwise_the_jax_build(adamw, n):
    p, m, v, g = arrays(n, n)
    hp = (1e-2, 0.9, 0.999, 0.01, 1 - 0.9 ** 3, 1 - 0.999 ** 3, 1e-8)
    want = _host_adam(p, m, v, g, *hp[:6], hp[6], adamw)
    tp, tm, tv, tg = (torch.from_numpy(x.copy()) for x in (p, m, v, g))
    ptr = tp.data_ptr()
    cpu_adam.ds_adam_step(tp, tm, tv, tg, hp[0], hp[1], hp[2], hp[6],
                          hp[3], hp[4], hp[5], adamw)
    assert tp.data_ptr() == ptr  # in place
    for got, ref in zip((tp, tm, tv), want):
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("adamw", [True, False], ids=["adamw", "l2"])
def test_optimizer_matches_the_plain_version(adamw):
    rng = np.random.default_rng(0)
    flat = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32))
    cpu = cpu_adam.DeepSpeedCPUAdam(lr=1e-2, weight_decay=0.01,
                                    adam_w_mode=adamw)
    pc, pg = flat.clone(), flat.clone()
    sc = cpu.init_state(pc)
    mg, vg = torch.zeros_like(pg), torch.zeros_like(pg)
    for step in range(1, 5):
        g = torch.from_numpy(rng.normal(size=flat.shape).astype(np.float32))
        cpu.update(sc, pc, g, cpu.hyperparams())
        cpu_adam.plain_adam_step(pg, mg, vg, g, 1e-2, 0.9, 0.999, 1e-8,
                                 0.01, step, adamw=adamw)
    assert sc.step == 4
    np.testing.assert_allclose(pc.numpy(), pg.numpy(), rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(sc.exp_avg_sq.numpy(), vg.numpy(),
                               rtol=2e-6, atol=1e-8)


def test_kernel_refuses_other_tensors():
    p, m, v, g = (torch.from_numpy(x) for x in arrays(8, 0))
    with pytest.raises(ValueError, match="contiguous fp32 host"):
        cpu_adam.ds_adam_step(p.double(), m, v, g, 1e-3, 0.9, 0.999, 1e-8,
                              0.0, 1.0, 1.0, True)
    with pytest.raises(ValueError, match="contiguous fp32 host"):
        cpu_adam.ds_adam_step(p, m, v.view(2, 4).t(), g, 1e-3, 0.9, 0.999,
                              1e-8, 0.0, 1.0, 1.0, True)
    with pytest.raises(ValueError, match="differ in size"):
        cpu_adam.ds_adam_step(p, m, v, g[:4], 1e-3, 0.9, 0.999, 1e-8, 0.0,
                              1.0, 1.0, True)


def jax_losses(opt_type, steps=4):
    mesh = make_mesh({"data": 1}, devices=jax.devices("cpu")[:1])
    config = base_config(train_batch_size=16,
                         optimizer={"type": opt_type, "params": {"lr": 1e-2}})
    params = SimpleModel(HIDDEN, nlayers=2).init(0)
    engine, *_ = jds.initialize(
        model=JSimpleModel(HIDDEN, nlayers=2), config=config, mesh=mesh,
        model_parameters=jax.tree_util.tree_map(jax.numpy.asarray, params))
    batch = random_batches(1, 16, HIDDEN, seed=0)[0]
    return [float(np.asarray(engine.train_batch(iter([batch]))))
            for _ in range(steps)]


@pytest.mark.parametrize("offload", [False, True], ids=["device",
                                                        "offload"])
def test_engine_matches_the_jax_cpu_adam_engine(one_thread, offload):
    config = base_config(optimizer={"type": "CPUAdam",
                                    "params": {"lr": 1e-2}})
    if offload:
        config["zero_optimization"] = {"stage": 2, "cpu_offload": True}
    model = SimpleModel(HIDDEN, nlayers=2)
    engine, opt, *_ = tds.initialize(model=model, config=config,
                                     model_parameters=model.init(0),
                                     device="cpu")
    assert type(opt).__name__ == "DeepSpeedCPUAdam"
    batch = random_batches(1, 16, HIDDEN, seed=0)[0]
    before = cpu_adam.ds_adam_step.launches
    got = [float(engine.train_batch(iter([batch]))) for _ in range(4)]
    assert cpu_adam.ds_adam_step.launches - before == 4
    np.testing.assert_allclose(got, jax_losses("CPUAdam"), rtol=1e-5)
    if offload:
        assert engine.host_stream_schedule() is None
        assert engine.master.device.type == "cpu"


def test_the_update_loop_is_vectorized(tmp_path):
    """g++ places an OpenMP simd loop's report on its first statement:
    a report on a line of the loop (its ``for`` to its closing brace)."""
    src = op_builder.CSRC_DIR / op_builder.HOST_SOURCES["cpu_adam"]
    lines = src.read_text().splitlines()
    first = next(i for i, line in enumerate(lines, 1)
                 if line.strip().startswith("for (long long i = 0;"))
    last = next(i for i in range(first, len(lines) + 1)
                if lines[i - 1] == "  }")
    out = subprocess.run(
        [op_builder.find_gxx(), *op_builder.GXX_FLAGS,
         "-fopt-info-vec-optimized", "-o", str(tmp_path / "adam.so"),
         str(src)], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    at = [int(n) for n in re.findall(
        r"cpu_adam\.cpp:(\d+):\d+: optimized: loop vectorized", out.stderr)]
    assert any(first <= n <= last for n in at), out.stderr


@pytest.mark.parametrize("threads", [1, 3])
def test_team_sizes_are_bitwise_the_jax_build(threads):
    n = 256 * 1024 + 5
    p, m, v, g = arrays(n, 7)
    hp = (1e-3, 0.9, 0.999, 0.0, 1 - 0.9 ** 2, 1 - 0.999 ** 2, 1e-8)
    want = _host_adam(p, m, v, g, *hp[:6], hp[6], 1)
    tp, tm, tv, tg = (torch.from_numpy(x.copy()) for x in (p, m, v, g))
    cpu_adam.ds_adam_step(tp, tm, tv, tg, hp[0], hp[1], hp[2], hp[6],
                          hp[3], hp[4], hp[5], 1, threads=threads)
    for got, ref in zip((tp, tm, tv), want):
        np.testing.assert_array_equal(got.numpy(), ref)


def test_host_threads_split_the_host_over_its_ranks():
    def team(env, cpus=32, host_cpus=32):
        return cpu_adam.host_threads(env, cpus=cpus, host_cpus=host_cpus)

    assert team({}) == 0
    assert team({"LOCAL_WORLD_SIZE": "1"}) == 0
    # torchrun's OMP_NUM_THREADS=1 under several ranks is overridden
    assert team({"LOCAL_WORLD_SIZE": "4", "OMP_NUM_THREADS": "1"}) == 8
    assert team({"LOCAL_WORLD_SIZE": "3"}) == 10
    assert team({"LOCAL_WORLD_SIZE": "128"}) == 1
    # a team the user set is OpenMP's to take
    assert team({"LOCAL_WORLD_SIZE": "4", "OMP_NUM_THREADS": "6"}) == 0
    # a rank pinned to CPUs of its own keeps them all
    assert team({"LOCAL_WORLD_SIZE": "4"}, cpus=8) == 8
    assert cpu_adam.host_threads({"LOCAL_WORLD_SIZE": "2"}) >= 1


def test_host_library_path_follows_source_and_flags(tmp_path, monkeypatch):
    import shutil

    copy = tmp_path / "csrc"
    shutil.copytree(op_builder.CSRC_DIR, copy)
    monkeypatch.setattr(op_builder, "CSRC_DIR", copy)
    monkeypatch.setattr(op_builder, "BUILD_DIR", tmp_path / "build")
    base = op_builder.host_library_path("cpu_adam")
    assert base == op_builder.host_library_path("cpu_adam")
    assert base.parent == op_builder.BUILD_DIR
    src = copy / op_builder.HOST_SOURCES["cpu_adam"]
    src.write_text(src.read_text() + "\n// edited\n")
    assert op_builder.host_library_path("cpu_adam") != base
    monkeypatch.setattr(op_builder, "GXX_FLAGS",
                        op_builder.GXX_FLAGS + ("-DEXTRA",))
    assert op_builder.host_library_path("cpu_adam") != base


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(op_builder, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(op_builder, "GXX_FLAGS",
                        op_builder.GXX_FLAGS + ("-DX=", "-include",
                                                "no_such_header.h"))
    with pytest.raises(RuntimeError, match="no_such_header"):
        op_builder.build(["cpu_adam"])
