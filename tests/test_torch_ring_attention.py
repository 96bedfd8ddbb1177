"""Ring attention of the port (sequence parallelism, the ``seq`` axis)
against the JAX package's ``ring_attention`` on the virtual CPU mesh.

The port's ranks are four gloo processes (:func:`tests.torch_seq_workers.op_world`,
one spawn for the module) on ``{"seq": 4}`` and ``{"data": 2, "seq":
2}``; each runs its chunk through :class:`RingFlashAttention` (whose
per-pair wrappers run their plain versions on the CPU) and through
:func:`ring_attention` recomputed in backward, as a layer under remat
runs it.  The JAX function runs on the same meshes over the conftest's
virtual devices (``jax.shard_map``: the real ring).  Every comparison is
fp32 at 1e-5 (atol and rtol).

- forward and dq, dk, dv, causal and bidirectional, data 2 × seq 2, a
  key mask whose last chunk is all padding, a custom scale;
- the one-process schedule (:func:`ring_flash_attention_local`) is
  bitwise the ranks' kernel path;
- a row whose every key is padded: the JAX ring averages its −1e9
  scores, while the port gives 0, as B1 does (ROADMAP C's caveats);
- one shard, in this process: the FlashAttention path against the JAX
  dense fallback, with a key mask and a custom scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from deepspeed_tpu.ops.transformer.ring_attention import \
    ring_attention as jax_ring
from deepspeed_tpu.parallel import make_mesh as jax_mesh
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.ops.transformer.ring_attention import (
    ring_attention, ring_flash_attention_local)
from deepspeed_tpu_torch.parallel import Mesh

from . import torch_seq_workers as W
from .torch_dist import run_ranks

TOL = 1e-5
CASES = {c[0]: c[1:] for c in W.OP_CASES}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Plain versions on one intra-op thread (ROADMAP C1: torch's first
    CPU exp of a process, made by two threads at once, can come out of
    a reduced-accuracy path)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(W.op_world, W.WORLD, tmp_path_factory.mktemp("ring"))


def _whole(ranks, name, path, i):
    """The ranks' chunks of output ``i`` (out, dq, dk, dv) joined into the
    whole [b, s, h, d] array, by the rank layout of the case's mesh."""
    dims = CASES[name][0]
    dp, n = dims.get("data", 1), dims["seq"]
    rows = [np.concatenate([ranks[d * n + r][name][path][i]
                            for r in range(n)], axis=1) for d in range(dp)]
    return np.concatenate(rows, axis=0)


def _jax_case(name):
    """The JAX ring's out and grads on the case's mesh."""
    dims, b, causal, key_mask, scale = CASES[name]
    q, k, v, g, kpm = W.op_inputs(b, **W.OP_SHAPE, key_mask=key_mask)
    n = int(np.prod(list(dims.values())))
    mesh = jax_mesh(dims, devices=jax.devices("cpu")[:n])
    spec = P("data", "seq") if "data" in dims else P(None, "seq")
    put = (lambda x: jax.device_put(jnp.asarray(x),
                                    NamedSharding(mesh, spec)))
    args = [put(x) for x in (q, k, v)]
    m = None if kpm is None else put(kpm)

    def f(q, k, v):
        return jax_ring(q, k, v, mesh=mesh, causal=causal,
                        key_padding_mask=m, scale=scale)

    with mesh:
        out = jax.jit(f)(*args)
        grads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * g),
                                 argnums=(0, 1, 2)))(*args)
    return [np.asarray(out)] + [np.asarray(x) for x in grads]


@pytest.mark.parametrize("path", ["recomputed", "flash"])
@pytest.mark.parametrize("name", [c[0] for c in W.OP_CASES
                                  if c[0] != "seq4_padded_row"])
def test_ring_matches_the_jax_ring(ranks, name, path):
    want = _jax_case(name)
    for i, label in enumerate(("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(_whole(ranks, name, path, i), want[i],
                                   rtol=TOL, atol=TOL, err_msg=label)


@pytest.mark.parametrize("name", [c[0] for c in W.OP_CASES])
def test_one_process_schedule_is_bitwise_the_ranks(ranks, name):
    dims, b, causal, key_mask, scale = CASES[name]
    q, k, v, g, kpm = W.op_inputs(b, **W.OP_SHAPE, key_mask=key_mask)
    dp, n = dims.get("data", 1), dims["seq"]
    per = b // dp
    got = [[] for _ in range(4)]
    for d in range(dp):
        rows = slice(d * per, (d + 1) * per)
        qkv = [torch.from_numpy(np.ascontiguousarray(x[rows]))
               .requires_grad_() for x in (q, k, v)]
        qq = qkv[0] if scale is None else \
            qkv[0] * (scale * W.OP_SHAPE["d"] ** 0.5)
        out = ring_flash_attention_local(
            qq, qkv[1], qkv[2], n, causal=causal,
            key_padding_mask=None if kpm is None
            else torch.from_numpy(kpm[rows]))
        grads = torch.autograd.grad(out, qkv, torch.from_numpy(g[rows]))
        for i, x in enumerate([out.detach()] + list(grads)):
            got[i].append(x.numpy())
    for i in range(4):
        np.testing.assert_array_equal(np.concatenate(got[i]),
                                      _whole(ranks, name, "flash", i))


def test_fully_padded_row_plain_averages_and_kernel_path_gives_zero(ranks):
    """Row 1's keys are all padded: the JAX ring, the plain reference,
    averages the values there (every score is −1e9); the port gives 0
    there, as B1 gives a fully masked row, and zero gradients, on both
    paths; row 0 agrees with the JAX ring everywhere."""
    name = "seq4_padded_row"
    want = _jax_case(name)
    _, v = W.op_inputs(2, **W.OP_SHAPE, key_mask="row")[1:3]
    np.testing.assert_allclose(want[0][1], np.broadcast_to(
        v[1].mean(axis=0), v[1].shape), rtol=TOL, atol=TOL)
    for path in ("recomputed", "flash"):
        got = [_whole(ranks, name, path, i) for i in range(4)]
        for i in range(4):
            np.testing.assert_allclose(got[i][0], want[i][0], rtol=TOL,
                                       atol=TOL)
            # no key of row 1 is seen: its out, dq, dk and dv are 0
            assert not got[i][1].any()


@pytest.mark.parametrize("causal,key_mask,scale", [
    (True, None, None), (False, "chunk", None), (False, None, 0.05)],
    ids=["causal", "padded", "scale"])
def test_one_shard_runs_flash_attention_like_the_jax_fallback(
        causal, key_mask, scale):
    """At one seq rank the port runs FlashAttention (q pre-scaled for a
    custom scale), the JAX function its dense fallback."""
    q, k, v, g, kpm = W.op_inputs(2, **W.OP_SHAPE, key_mask=key_mask)
    mesh = jax_mesh({"seq": 1}, devices=jax.devices("cpu")[:1])
    m = None if kpm is None else jnp.asarray(kpm)

    def f(q, k, v):
        return jax_ring(q, k, v, mesh=mesh, causal=causal,
                        key_padding_mask=m, scale=scale)

    want = [f(*map(jnp.asarray, (q, k, v)))] + list(jax.grad(
        lambda *a: jnp.sum(f(*a) * g), argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v))))
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    launches = fa.flash_attention_fwd.launches
    out = ring_attention(*qkv, mesh=Mesh({"seq": 1}), causal=causal,
                         key_padding_mask=None if kpm is None
                         else torch.from_numpy(kpm), scale=scale)
    grads = torch.autograd.grad(out, qkv, torch.from_numpy(g))
    for got, exp in zip([out.detach()] + list(grads), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=TOL,
                                   atol=TOL)
    # the CPU runs B1's plain version, which counts no launch
    assert fa.flash_attention_fwd.launches == launches
