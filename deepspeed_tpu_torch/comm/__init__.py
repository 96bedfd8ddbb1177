"""Communication: named-axis collectives over ``torch.distributed``
(port of ``deepspeed_tpu/comm/__init__.py``).

The JAX package routes every collective through this one module,
expressed over named mesh axes.  The port keeps the verbs and their
names; each runs on the process group of its axis in a
:class:`~deepspeed_tpu_torch.parallel.mesh.Mesh` (the one passed, else
the engine's current mesh): NCCL on the card, gloo on the CPU.  An axis
without a process group (one process, no ``torch.distributed``) has one
member, and its collectives are identities.

==============================  ==========================================
JAX package (``jax.lax``)       here (``torch.distributed``)
==============================  ==========================================
psum / pmean / pmax / pmin      all_reduce (SUM, SUM then / size, MAX, MIN)
reduce_scatter (psum_scatter)   reduce_scatter_tensor
all_gather                      all_gather_into_tensor
axis_index / axis_size          the rank and size in the axis's group
ppermute                        pipeline p2p: ROADMAP A13
all_to_all                      sequence/expert parallelism: ROADMAP A10
==============================  ==========================================

Every verb returns a new tensor, as the JAX verbs do, or writes into
``out`` (which may be the input itself for the reductions): the engine
exchanges its flat buffers in place.  ``counter`` counts the collectives
issued and the bytes of the buffers they cover.
"""

import torch.distributed as dist

from ..parallel.mesh import DATA_AXIS, get_current_mesh

# torch 2.13 renamed the two flat-buffer collectives
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class CommCounter:
    """Collectives issued by this process, by verb: ``calls[verb]`` and
    ``bytes[verb]`` (the larger of the input and the output buffer, so
    the whole flat buffer for a reduce-scatter and for an all-gather)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls = {}
        self.bytes = {}

    def add(self, verb, nbytes):
        self.calls[verb] = self.calls.get(verb, 0) + 1
        self.bytes[verb] = self.bytes.get(verb, 0) + int(nbytes)


counter = CommCounter()


def _axis(axis_name, mesh):
    """``(process group or None, size)`` of ``axis_name``."""
    mesh = mesh if mesh is not None else get_current_mesh()
    if mesh is None:
        raise ValueError(f"collective over axis {axis_name!r} with no mesh: "
                         "pass mesh= or build an engine on one")
    group, size = mesh.group(axis_name), mesh.size(axis_name)
    if group is None and size > 1:
        raise RuntimeError(f"mesh axis {axis_name!r} of size {size} has no "
                           f"process group: build the mesh with make_mesh "
                           f"under torch.distributed")
    return group, size


def _all_reduce(x, axis_name, mesh, op, out, verb):
    group, _ = _axis(axis_name, mesh)
    if out is None:
        out = x.clone()
    elif out is not x:
        out.copy_(x)
    if group is not None:
        counter.add(verb, out.numel() * out.element_size())
        dist.all_reduce(out, op=op, group=group)
    return out


def psum(x, axis_name, mesh=None, out=None):
    """Sum-allreduce over a mesh axis (reference: dist.all_reduce SUM)."""
    return _all_reduce(x, axis_name, mesh, dist.ReduceOp.SUM, out, "psum")


def pmean(x, axis_name, mesh=None, out=None):
    """Mean-allreduce: the sum over the axis, then / its size (gloo has
    no AVG)."""
    out = psum(x, axis_name, mesh, out)
    n = axis_size(axis_name, mesh)
    return out.div_(n) if n > 1 else out


def pmax(x, axis_name, mesh=None, out=None):
    """Max-allreduce (reference: dist.all_reduce MAX, overflow flags)."""
    return _all_reduce(x, axis_name, mesh, dist.ReduceOp.MAX, out, "pmax")


def pmin(x, axis_name, mesh=None, out=None):
    return _all_reduce(x, axis_name, mesh, dist.ReduceOp.MIN, out, "pmin")


def reduce_scatter(x, axis_name, scatter_dimension=0, tiled=True, mesh=None,
                   out=None):
    """Sum-reduce, then scatter dim 0 in equal contiguous pieces over the
    axis (reference: the ZeRO reduce-to-owner pattern, ``stage2.py:727``):
    member ``i`` gets piece ``i``.  ``tiled=False`` takes ``x`` of
    leading dim equal to the axis size and drops that dim."""
    if scatter_dimension != 0:
        raise NotImplementedError("reduce_scatter scatters dim 0 only")
    group, n = _axis(axis_name, mesh)
    x = x.contiguous()
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over "
                         f"{n} members of {axis_name!r}")
    shape = (x.shape[0] // n, *x.shape[1:])
    if out is None:
        out = x.new_empty(shape)
    if group is None:
        out.copy_(x.view(shape))
    else:
        counter.add("reduce_scatter", x.numel() * x.element_size())
        _reduce_scatter(out, x, op=dist.ReduceOp.SUM, group=group)
    return out if tiled else out.view(x.shape[1:])


def all_gather(x, axis_name, axis=0, tiled=True, mesh=None, out=None):
    """Gather every member's ``x`` along dim 0 (reference: dist.all_gather,
    the ZeRO param reassembly ``stage2.py:1444-1477``): concatenated
    (``tiled``) or stacked on a new leading dim."""
    if axis != 0:
        raise NotImplementedError("all_gather gathers along dim 0 only")
    group, n = _axis(axis_name, mesh)
    x = x.contiguous()
    shape = ((x.shape[0] * n, *x.shape[1:]) if tiled
             else (n, *x.shape))
    if out is None:
        out = x.new_empty(shape)
    if group is None:
        out.copy_(x.view(shape))
    else:
        counter.add("all_gather", out.numel() * out.element_size())
        _all_gather(out.view(-1), x.view(-1), group=group)
    return out


def ppermute(x, axis_name, perm):
    """Point-to-point ring: the pipeline's p2p, not ported yet."""
    raise NotImplementedError("ppermute (pipeline p2p) is not ported yet "
                              "(ROADMAP A13)")


def all_to_all(x, axis_name, split_axis, concat_axis, tiled=True):
    """All-to-all: sequence and expert parallelism, not ported yet."""
    raise NotImplementedError("all_to_all (sequence/expert parallelism) is "
                              "not ported yet (ROADMAP A10)")


def axis_index(axis_name, mesh=None):
    """This rank's coordinate along the axis (reference:
    dist.get_rank(group))."""
    mesh = mesh if mesh is not None else get_current_mesh()
    return 0 if mesh is None else mesh.index(axis_name)


def axis_size(axis_name, mesh=None):
    """Size of the axis (reference: dist.get_world_size(group))."""
    mesh = mesh if mesh is not None else get_current_mesh()
    return 1 if mesh is None else mesh.size(axis_name)


def barrier(axis_name=DATA_AXIS, mesh=None):
    """Wait for every member of the axis."""
    group, _ = _axis(axis_name, mesh)
    if group is not None:
        dist.barrier(group=group)


def data_parallel_mean_count(count):
    """A loss's normaliser made global: ``max(total, 1) / n``, where
    ``total`` is ``count`` (this rank's number of counted items, a
    tensor) summed over the current mesh's data axis and ``n`` is its
    size.  A loss ``local_sum / mean_count`` then averages over the ranks
    to the global batch's ``total_sum / max(total_count, 1)``, as the JAX
    engine's loss over the global batch is; where every rank counts the
    same, the mean count is the count itself.  Without a mesh, or at one
    data-parallel rank, this is ``count.clamp_min(1)``."""
    mesh = get_current_mesh()
    if mesh is None or mesh.size(DATA_AXIS) == 1:
        return count.clamp_min(1)
    total = psum(count.float(), DATA_AXIS, mesh)
    return total.clamp_min(1) / mesh.size(DATA_AXIS)
