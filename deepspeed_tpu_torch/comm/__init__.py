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
all_to_all                      all_to_all_single
ppermute                        batch_isend_irecv (:func:`send_recv`)
==============================  ==========================================

Every verb returns a new tensor, as the JAX verbs do, or writes into
``out`` (which may be the input itself for the reductions): the engine
exchanges its flat buffers in place.  ``reduce_scatter`` and
``all_gather`` also run asynchronously (``async_op=True``): they return
``(out, handle)``, and ``out`` holds the result once ``handle.wait()``
returned (on the card, once the current stream reaches the wait).  The
bucketed ZeRO exchange issues its collectives so, in the same order on
every rank.  ``counter`` counts the collectives issued and the bytes of
the buffers they cover.  The verbs run on any axis whose group exists,
and the reductions on a tuple of axes too (``psum(x, ("pipe",
"data"))``, the group over both), ``seq`` included.

Tensor and expert parallelism (Megatron's ``mappings``) go through
three autograd regions over a named axis or tuple of axes, each an
identity where the axis has one member: :func:`copy_to` (identity
forward, sum-allreduce of the gradient backward: the input of a
column-parallel product), :func:`reduce_from` (sum-allreduce forward,
identity backward: the output of a row-parallel product) and
:func:`gather_from` (all-gather along a dim forward, this member's
slice of the gradient backward).  In the JAX package GSPMD inserts the
same collectives from the partition specs.

Point-to-point (:func:`send_recv`, :func:`ppermute`) is the pipeline's
and ring attention's: a step's sends and receives to neighbouring
stages (or ``seq`` ranks) go out together through one
``batch_isend_irecv`` and are waited for together, so two ranks that
send to each other in the same step cannot deadlock.  With
``async_op=True`` it returns a handle instead of waiting, so the ring
posts the next key/value chunk before it launches the current pair's
kernel.  It counts ``send`` and ``recv`` calls and bytes.

The counter also tells its trackers whether a call was asynchronous,
and when its handle was waited for: the overlap model prices the compute
dispatched between a call's issue and its wait as the window that hides
it.
"""

import torch
import torch.distributed as dist

from ..parallel.mesh import (DATA_AXIS, PIPE_AXIS, SEQ_AXIS,
                             get_current_mesh, sequence_is_whole)

# torch 2.13 renamed the two flat-buffer collectives
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class _Done:
    """The handle of a collective that completed when it was issued (an
    axis of one member)."""

    def wait(self):
        return True


class _Requests:
    """The handle of a batch of point-to-point requests: ``wait`` waits
    for every one of them."""

    def __init__(self, reqs):
        self.reqs = reqs

    def wait(self):
        for req in self.reqs:
            req.wait()
        return True


class _Watched:
    """An asynchronous call's handle whose ``wait`` also tells the
    counter's trackers that the call completed (after the wait)."""

    def __init__(self, handle, on_wait):
        self.handle = handle
        self.on_wait = on_wait

    def wait(self):
        out = self.handle.wait()
        for done in self.on_wait:
            done()
        return out


class CommCounter:
    """Collectives issued by this process, by verb: ``calls[verb]`` and
    ``bytes[verb]`` (the larger of the input and the output buffer, so
    the whole flat buffer for a reduce-scatter and for an all-gather).
    Each call is also handed to every callable in ``listeners`` as
    ``(verb, nbytes, group_size)``: the comm ledger
    (:class:`~deepspeed_tpu_torch.profiling.comm.CommLedger`) records a
    phase's collectives so.  Every callable in ``trackers`` gets
    ``(verb, nbytes, group_size, async_op)`` and may return a callable,
    which runs when the call's handle is waited for (:meth:`watch`): the
    overlap model (:mod:`~deepspeed_tpu_torch.profiling.overlap`) places
    a call's issue and its wait in the step's dispatch order so."""

    def __init__(self):
        self.listeners = []
        self.trackers = []
        self.reset()

    def reset(self):
        self.calls = {}
        self.bytes = {}

    def add(self, verb, nbytes, group=1, async_op=False):
        """Count one call; returns the trackers' wait callbacks (an
        empty list for a blocking call, or without trackers)."""
        self.calls[verb] = self.calls.get(verb, 0) + 1
        self.bytes[verb] = self.bytes.get(verb, 0) + int(nbytes)
        for listen in self.listeners:
            listen(verb, int(nbytes), int(group))
        on_wait = []
        for track in self.trackers:
            done = track(verb, int(nbytes), int(group), bool(async_op))
            if done is not None and async_op:
                on_wait.append(done)
        return on_wait

    @staticmethod
    def watch(handle, on_wait):
        """``handle``, whose ``wait`` runs ``on_wait`` after it (itself
        when there is nothing to run)."""
        return _Watched(handle, on_wait) if on_wait else handle


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
    group, n = _axis(axis_name, mesh)
    if out is None:
        # contiguous: NCCL refuses a strided buffer (an einsum's output)
        out = x.clone(memory_format=torch.contiguous_format)
    elif out is not x:
        out.copy_(x)
    if group is not None:
        counter.add(verb, out.numel() * out.element_size(), n)
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


def psum_group(x, group):
    """Sum-allreduce of ``x`` in place over a process group that is no
    mesh axis (the pipeline's tied-parameter copies)."""
    counter.add("psum", x.numel() * x.element_size(),
                dist.get_world_size(group))
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def pmax(x, axis_name, mesh=None, out=None):
    """Max-allreduce (reference: dist.all_reduce MAX, overflow flags)."""
    return _all_reduce(x, axis_name, mesh, dist.ReduceOp.MAX, out, "pmax")


def pmin(x, axis_name, mesh=None, out=None):
    return _all_reduce(x, axis_name, mesh, dist.ReduceOp.MIN, out, "pmin")


def reduce_scatter(x, axis_name, scatter_dimension=0, tiled=True, mesh=None,
                   out=None, async_op=False):
    """Sum-reduce, then scatter dim 0 in equal contiguous pieces over the
    axis (reference: the ZeRO reduce-to-owner pattern, ``stage2.py:727``):
    member ``i`` gets piece ``i``.  ``tiled=False`` takes ``x`` of
    leading dim equal to the axis size and drops that dim.  With
    ``async_op`` it returns ``(out, handle)``; ``x`` must stay unchanged
    until the handle's ``wait``."""
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
    handle = _Done()
    if group is None:
        out.copy_(x.view(shape))
    else:
        on_wait = counter.add("reduce_scatter", x.numel() * x.element_size(),
                              n, async_op)
        handle = counter.watch(_reduce_scatter(
            out, x, op=dist.ReduceOp.SUM, group=group, async_op=async_op),
            on_wait)
    out = out if tiled else out.view(x.shape[1:])
    return (out, handle) if async_op else out


def all_gather(x, axis_name, axis=0, tiled=True, mesh=None, out=None,
               async_op=False):
    """Gather every member's ``x`` along dim 0 (reference: dist.all_gather,
    the ZeRO param reassembly ``stage2.py:1444-1477``): concatenated
    (``tiled``) or stacked on a new leading dim.  With ``async_op`` it
    returns ``(out, handle)``."""
    if axis != 0:
        raise NotImplementedError("all_gather gathers along dim 0 only")
    group, n = _axis(axis_name, mesh)
    x = x.contiguous()
    shape = ((x.shape[0] * n, *x.shape[1:]) if tiled
             else (n, *x.shape))
    if out is None:
        out = x.new_empty(shape)
    handle = _Done()
    if group is None:
        out.copy_(x.view(shape))
    else:
        on_wait = counter.add("all_gather", out.numel() * out.element_size(),
                              n, async_op)
        handle = counter.watch(_all_gather(out.view(-1), x.view(-1),
                                           group=group, async_op=async_op),
                               on_wait)
    return (out, handle) if async_op else out


def send_recv(sends=(), recvs=(), axis_name=PIPE_AXIS, mesh=None,
              async_op=False):
    """Point-to-point on ``axis_name``: every ``(tensor, index)`` of
    ``sends`` goes to the member at ``index`` of the axis, and every
    ``(buffer, index)`` of ``recvs`` is filled in place from the member at
    ``index``.  All of them are posted at once (``batch_isend_irecv``, on
    the axis's group) and waited for before this returns (on the card:
    before the current stream goes on), or, with ``async_op``, when the
    returned handle's ``wait()`` is called; the sent tensors must stay
    unchanged until then.  A pair with this rank's own index is a local
    copy.  The peer must make the matching calls in the same order, with
    buffers of the same shape and dtype."""
    group, n = _axis(axis_name, mesh)
    mesh = mesh if mesh is not None else get_current_mesh()
    me = mesh.index(axis_name)
    local = [t for t, i in sends if i == me]
    ops, on_wait = [], []
    for t, i in sends:
        if i != me:
            t = t.contiguous()
            on_wait += counter.add("send", t.numel() * t.element_size(), n,
                                   async_op)
            ops.append(dist.P2POp(dist.isend, t, mesh.peer(axis_name, i),
                                  group))
    for buf, i in recvs:
        if i == me:
            buf.copy_(local.pop(0))
        else:
            on_wait += counter.add("recv", buf.numel() * buf.element_size(),
                                   n, async_op)
            ops.append(dist.P2POp(dist.irecv, buf, mesh.peer(axis_name, i),
                                  group))
    handle = _Done()
    if ops:
        if group is None:
            raise RuntimeError(f"point-to-point on axis {axis_name!r} "
                               f"needs its process group")
        handle = counter.watch(_Requests(dist.batch_isend_irecv(ops)),
                               on_wait)
    if async_op:
        return handle
    handle.wait()


def ppermute(x, axis_name, perm, mesh=None):
    """``jax.lax.ppermute``: member ``src`` of the axis sends ``x`` to
    member ``dst`` for every ``(src, dst)`` in ``perm``; each member
    returns what it received, zeros where no pair names it as ``dst``
    (the ring shift of pipeline stages and of ring attention)."""
    mesh = mesh if mesh is not None else get_current_mesh()
    me = axis_index(axis_name, mesh)
    # contiguous: gloo and NCCL receive into dense buffers only
    out = torch.zeros_like(x, memory_format=torch.contiguous_format)
    send_recv(sends=[(x, dst) for src, dst in perm if src == me],
              recvs=[(out, src) for src, dst in perm if dst == me],
              axis_name=axis_name, mesh=mesh)
    return out


def all_to_all(x, axis_name, split_axis, concat_axis, tiled=True,
               mesh=None):
    """``jax.lax.all_to_all``: split ``x`` along ``split_axis`` into one
    chunk per member, send chunk ``i`` to member ``i``, and join the
    chunks received along ``concat_axis`` in member order (one
    ``all_to_all_single``).  ``tiled=False`` takes a ``split_axis`` of
    the axis size, drops it, and stacks the received chunks on a new
    axis at ``concat_axis``.  1-bit Adam's compressed all-reduce sends
    its packed sign chunks so (``comm/compression.py``)."""
    group, n = _axis(axis_name, mesh)
    size = x.shape[split_axis]
    if size % n or (not tiled and size != n):
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} does not "
                         f"split over {n} members of {axis_name!r}")
    parts = x.movedim(split_axis, 0).reshape(n, size // n,
                                             *x.movedim(split_axis, 0)
                                             .shape[1:]).contiguous()
    recv = torch.empty_like(parts)
    if group is None:
        recv.copy_(parts)
    else:
        counter.add("all_to_all", parts.numel() * parts.element_size(), n)
        dist.all_to_all_single(recv, parts, group=group)
    if not tiled:
        return torch.stack([recv[i, 0] for i in range(n)], dim=concat_axis)
    return torch.cat([recv[i].movedim(0, split_axis) for i in range(n)],
                     dim=concat_axis)


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


def _trivial(axis_name, mesh):
    mesh = mesh if mesh is not None else get_current_mesh()
    return mesh is None or mesh.size(axis_name) == 1, mesh


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, mesh):
        ctx.axis_name, ctx.mesh = axis_name, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return psum(grad.contiguous(), ctx.axis_name, ctx.mesh), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, mesh):
        return psum(x, axis_name, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, dim, mesh):
        ctx.axis_name, ctx.dim, ctx.mesh = axis_name, dim, mesh
        n = axis_size(axis_name, mesh)
        parts = all_gather(x.movedim(dim, 0), axis_name, mesh=mesh,
                           tiled=False)
        # [n, ..., x.shape[dim], ...] -> the members' pieces joined on dim
        return torch.cat([parts[i].movedim(0, dim) for i in range(n)],
                         dim=dim)

    @staticmethod
    def backward(ctx, grad):
        n = axis_size(ctx.axis_name, ctx.mesh)
        me = axis_index(ctx.axis_name, ctx.mesh)
        return grad.chunk(n, dim=ctx.dim)[me].contiguous(), None, None, None


class _GatherSum(_GatherFrom):
    @staticmethod
    def backward(ctx, grad):
        n = axis_size(ctx.axis_name, ctx.mesh)
        parts = torch.stack(grad.chunk(n, dim=ctx.dim))
        mine = reduce_scatter(parts, ctx.axis_name, mesh=ctx.mesh,
                              tiled=False)
        return mine, None, None, None


def copy_to(x, axis_name, mesh=None):
    """Identity forward; the gradient sum-allreduced over ``axis_name``
    backward (Megatron's ``copy_to_model_parallel_region``): ``x`` is the
    replicated input of a product each member computes a slice of."""
    trivial, mesh = _trivial(axis_name, mesh)
    return x if trivial else _CopyTo.apply(x, axis_name, mesh)


def reduce_from(x, axis_name, mesh=None):
    """Sum-allreduce over ``axis_name`` forward; the gradient as it is
    backward (``reduce_from_model_parallel_region``): ``x`` is each
    member's partial sum of a row-parallel product."""
    trivial, mesh = _trivial(axis_name, mesh)
    return x if trivial else _ReduceFrom.apply(x, axis_name, mesh)


def gather_from(x, axis_name, dim=-1, mesh=None):
    """All-gather along ``dim`` over ``axis_name`` forward, in member
    order; this member's slice of the gradient backward
    (``gather_from_model_parallel_region``)."""
    trivial, mesh = _trivial(axis_name, mesh)
    if trivial:
        return x
    return _GatherFrom.apply(x, axis_name, dim % x.dim(), mesh)


def gather_seq(x, dim=1, mesh=None, axis_name=SEQ_AXIS):
    """``x``'s chunks of every ``seq`` rank joined along ``dim`` (rank
    order) forward; backward the gradient summed over the axis and cut to
    this rank's chunk (a reduce-scatter), since every rank uses the whole
    and each use sends its part of the gradient back to the chunk's
    owner.  ``x`` itself at one rank."""
    trivial, mesh = _trivial(axis_name, mesh)
    if trivial:
        return x
    return _GatherSum.apply(x, axis_name, dim % x.dim(), mesh)


def data_parallel_mean_count(count):
    """A loss's normaliser made global: ``max(total, 1) / n``, where
    ``total`` is ``count`` (this rank's number of counted items, a
    tensor) summed over the current mesh's ``data`` and ``seq`` axes and
    ``n`` is the size of ``data``.  A loss ``local_sum / mean_count``
    then averages over the data ranks to the global batch's ``total_sum
    / max(total_count, 1)``, as the JAX engine's loss over the global
    batch is; where every rank counts the same, the mean count is the
    count itself.  Under ``seq`` each rank counts its chunk's items and
    its loss is a partial sum: the ``seq`` ranks' losses (and gradients)
    summed, then averaged over ``data``, give the global mean; where
    every ``seq`` rank holds the whole sequence
    (:func:`~deepspeed_tpu_torch.parallel.mesh.whole_sequence`) the sum
    runs over ``data`` alone.  Without a mesh, or at one rank of the
    axes summed, this is ``count.clamp_min(1)``."""
    mesh = get_current_mesh()
    axes = DATA_AXIS if sequence_is_whole() else (DATA_AXIS, SEQ_AXIS)
    if mesh is None or mesh.size(axes) == 1:
        return count.clamp_min(1)
    total = psum(count.float(), axes, mesh)
    return total.clamp_min(1) / mesh.size(DATA_AXIS)
