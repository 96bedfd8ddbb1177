"""The flat fp32 master and its views (port of
``deepspeed_tpu/runtime/zero/coordinator.py``: ``flatten_to_master``,
``unflatten_params``, ``gather_master_unpadded`` and its inverses
``repad_unpadded`` / ``scatter_master_from_unpadded``, ``:512``, ``:528``;
the stage-3 and bucket-plan parts of ``:158-615``).

Every parameter lives in one ``(rows, LANES)`` fp32 buffer in the
row-aligned layout of :func:`~deepspeed_tpu_torch.ops.op_common.build_segments`,
leaves in the JAX package's order (dict keys sorted), so a flat buffer,
and the unpadded 1-D checkpoint form, mean the same in both packages.
The engine's flat compute and gradient buffers take the same layout in
the compute dtype (bf16, fp16 or fp32): :meth:`unflatten_params` gives
the param dict's views of any of them, and the compute buffer is the
master's cast, one copy.
ZeRO-1/2 under a data-parallel mesh (JAX ``coordinator.py`` with the
master sharded over the ``data`` axis): the rows are padded to a
multiple of the data-parallel degree and each rank owns a contiguous
row range of the master, so the same range of the optimizer state
(:attr:`row0`, :attr:`shard_rows`, :meth:`row_shard`);
:meth:`flatten_to_master` gives that rank's rows, and
:meth:`gather_master_unpadded` / :meth:`scatter_master_from_unpadded`
gather and re-pad across the ranks, so a checkpoint's unpadded form is
the same at every degree.  Stage 0 keeps one whole buffer on every rank.
Stage 3 shards the master as stages 1 and 2 do; the engine then keeps no
persistent compute copy of the parameters (it gathers them for the
forward and the backward only).  A pipeline stage builds its layout from
its own stage tree (its layers and its copy of each tied param, never
the whole model), and ZeRO-1/2 shard it over the stage's data group
exactly so.

Under ``overlap_comm`` (a :class:`~deepspeed_tpu_torch.runtime.zero.buckets.BucketPlan`,
``plan``) the compute params and the gradient take the plan's canonical
layout (:attr:`segments` is the plan's: buckets one after another, each
padded to a multiple of the data-parallel degree), and the master and
the optimizer state its shard-major order: each rank's contiguous rows
are its piece of every bucket.  The checkpoint form stays the canonical
unpadded one, through the plan, so every layout loads every other.

Under ``cpu_offload`` (JAX ``coordinator.py:225-242``, ``:352-380``) the
master and the optimizer state are host buffers in their storage dtype,
one per family (:meth:`host_buffer`, :meth:`flatten_to_host`,
:meth:`alloc_host_grads`): pinned when the engine trains on the card,
allocated pinned and filled in place (pinning a filled tensor would
hold two copies), plain CPU tensors when it trains on the CPU.  Each
holds this rank's rows (:attr:`shard_shape`: the whole layout when the
master is whole), so the ranks of a data group together hold one copy
of the state, as the JAX engine's ``P("data")`` host sharding does; a
gather stages host rows through ``device`` for the collective, a chunk
at a time, into a host buffer.  The
JAX package splits them into row groups under XLA's per-host-buffer
bound; the port has no such bound and keeps one group.
"""

import numpy as np
import torch

from ... import comm
from ...ops.op_common import LANES, RowShard, build_segments
from ...parallel.mesh import DATA_AXIS
from ...utils.params import tree_from_leaves, tree_leaves


# every rank's rows of one chunk of a host gather, staged on the card
HOST_GATHER_BYTES = 64 << 20


class FlatParamCoordinator:
    """The flat layout of a param tree.  ``mesh`` (with ``dp_size``
    ranks on its ``data`` axis, this one ``dp_rank``) partitions the
    master and the optimizer state at stages 1 and 2."""

    def __init__(self, params_template, stage=0, dp_size=1, dp_rank=0,
                 mesh=None, plan=None, device=None):
        self.stage = stage
        # where a partitioned gather runs (NCCL moves device memory only)
        self.device = torch.device(device or "cpu")
        self.dp_size = dp_size
        self.dp_rank = dp_rank
        self.mesh = mesh
        self.plan = plan
        self.paths, leaves = tree_leaves(params_template)
        self.shapes = [tuple(np.shape(leaf)) for leaf in leaves]
        sizes = [int(np.prod(shape)) for shape in self.shapes]
        self.segments = (plan.segments if plan is not None else
                         build_segments(sizes,
                                        pad_to=dp_size if stage >= 1 else 1))
        self.partitioned = stage >= 1 and mesh is not None
        self.shard_rows = (self.segments.rows // dp_size if self.partitioned
                           else self.segments.rows)
        self.row0 = dp_rank * self.shard_rows if self.partitioned else 0

    @property
    def shard_shape(self):
        """This rank's rows of the master and the optimizer state."""
        return (self.shard_rows, LANES)

    def row_shard(self):
        """This rank's :class:`~deepspeed_tpu_torch.ops.op_common.RowShard`
        (None when the master is whole): its per-tensor sums go over the
        ``data`` axis."""
        if not self.partitioned:
            return None
        mesh = self.mesh
        return RowShard(self.row0, self.shard_rows,
                        lambda t: comm.psum(t, DATA_AXIS, mesh, out=t))

    @property
    def flat_shape(self):
        return self.segments.shape

    def flatten_to_master(self, params, device):
        """The ``(rows, LANES)`` fp32 master on ``device`` (this rank's
        rows of it when partitioned), filled leaf by leaf on the host
        (numpy or tensor leaves; padding zero)."""
        _, leaves = tree_leaves(params)
        if len(leaves) != self.segments.num_segments:
            raise ValueError(f"the tree has {len(leaves)} leaves but the "
                             f"layout was built for "
                             f"{self.segments.num_segments}")
        host = np.zeros(self.segments.total, np.float32)
        for leaf, ro, n in zip(leaves, self.segments.row_offsets,
                               self.segments.sizes):
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.detach().float().cpu().numpy()
            host[ro * LANES:ro * LANES + n] = np.asarray(
                leaf, np.float32).reshape(-1)
        host = self.storage_from_canonical(host)
        return torch.from_numpy(
            host[self.row0:self.row0 + self.shard_rows]).to(device)

    def host_buffer(self, dtype, pin):
        """A zero host buffer of this rank's rows of the flat layout
        (``pin``: page-locked, for copies to and from the card without a
        staging copy)."""
        return torch.zeros(self.shard_shape, dtype=dtype, pin_memory=pin)

    def flatten_to_host(self, params, dtype, pin):
        """This rank's rows of the master as a host buffer in storage
        ``dtype``, allocated once and filled in place from the leaves
        that reach them (a cast to bf16 rounds to nearest, as numpy's
        ``astype`` does in the JAX package)."""
        _, leaves = tree_leaves(params)
        if len(leaves) != self.segments.num_segments:
            raise ValueError(f"the tree has {len(leaves)} leaves but the "
                             f"layout was built for "
                             f"{self.segments.num_segments}")
        host = self.host_buffer(dtype, pin)
        flat = host.view(-1)
        lo = self.row0 * LANES
        hi = lo + flat.numel()
        with torch.no_grad():
            for leaf, ro, n in zip(leaves, self.segments.row_offsets,
                                   self.segments.sizes):
                start = ro * LANES
                a, b = max(start, lo), min(start + n, hi)
                if a >= b:
                    continue
                src = (leaf.detach().float().cpu()
                       if isinstance(leaf, torch.Tensor)
                       else torch.from_numpy(np.asarray(leaf, np.float32)))
                flat[a - lo:b - lo].copy_(src.reshape(-1)[a - start:b - start])
        return host

    def alloc_host_grads(self, pin):
        """The fp32 host gradient buffer of ``offload_gradients`` (this
        rank's rows)."""
        return self.host_buffer(torch.float32, pin)

    def unflatten_params(self, flat):
        """The param dict of ``flat`` (any dtype, the master's layout):
        each leaf a VIEW of its rows, so a write to the buffer is a write
        to the params and one ``.grad`` buffer in this layout serves
        every leaf."""
        view = flat.view(-1)
        leaves = [view[ro * LANES:ro * LANES + n].view(shape)
                  for ro, n, shape in zip(self.segments.row_offsets,
                                          self.segments.sizes, self.shapes)]
        return tree_from_leaves(self.paths, leaves)

    def storage_from_canonical(self, host):
        """A host array in the canonical layout as the master stores it
        (the plan's shard-major order; itself without a plan)."""
        host = np.asarray(host).reshape(self.segments.shape)
        return (self.plan.storage_from_canonical(host)
                if self.plan is not None else host)

    def canonical_master(self, master):
        """The whole master (any buffer in its layout, every rank's rows
        gathered when partitioned: a collective) in the canonical layout
        of the compute params, on its device."""
        if self.partitioned and self.dp_size > 1:
            master = (self._gather_host_rows(master.detach())
                      if master.device.type == "cpu" else
                      comm.all_gather(master.detach(), DATA_AXIS,
                                      mesh=self.mesh))
        if self.plan is None:
            return master
        return self.plan.canonical_from_storage(master)

    def _gather_host_rows(self, rows):
        """Every rank's ``rows`` (host buffers of the ranks' rows) as one
        host buffer of the whole layout, gathered a chunk of
        ``HOST_GATHER_BYTES`` at a time through :attr:`device`, so the
        card never holds more than one chunk of every rank's rows (a
        collective)."""
        out = torch.empty(self.flat_shape, dtype=rows.dtype)
        ranks = out.view(self.dp_size, self.shard_rows, LANES)
        step = max(1, HOST_GATHER_BYTES // (
            self.dp_size * LANES * rows.element_size()))
        for r0 in range(0, self.shard_rows, step):
            rc = min(step, self.shard_rows - r0)
            got = comm.all_gather(rows[r0:r0 + rc].to(self.device),
                                  DATA_AXIS, mesh=self.mesh)
            ranks[:, r0:r0 + rc].copy_(got.view(self.dp_size, rc, LANES))
        return out

    def gather_master_unpadded(self, master):
        """Concatenated true-sized 1-D fp32 host copy (checkpoint
        format) of ``master`` or any buffer in its layout: the segments
        are gathered on the buffer's device, then copied to the host
        once (a whole host buffer's are read where they are, with no
        round trip through the card; a bf16 one is upcast exactly).  The
        array owns its memory: no later step writes it.  Partitioned,
        ``master`` is this rank's rows: every rank gathers the whole
        buffer first, on the card, or on the host for host rows (a
        collective: every rank calls it)."""
        view = self.canonical_master(master).detach().reshape(-1)
        parts = [view[ro * LANES:ro * LANES + n] for ro, n in
                 zip(self.segments.row_offsets, self.segments.sizes)]
        if not parts:
            return np.zeros((0,), np.float32)
        return torch.cat(parts).float().cpu().numpy()

    def repad_unpadded(self, unpadded):
        """Inverse of :meth:`gather_master_unpadded` on the host: the
        ``(rows, LANES)`` fp32 array, padding zero.  The unpadded form
        does not depend on the ZeRO stage or the data-parallel degree
        that wrote it."""
        unpadded = np.asarray(unpadded, np.float32).reshape(-1)
        total = sum(self.segments.sizes)
        if unpadded.size != total:
            raise ValueError(f"unpadded buffer holds {unpadded.size} "
                             f"values but the model has {total} "
                             f"parameters")
        host = np.zeros(self.segments.total, np.float32)
        start = 0
        for ro, n in zip(self.segments.row_offsets, self.segments.sizes):
            host[ro * LANES:ro * LANES + n] = unpadded[start:start + n]
            start += n
        return host.reshape(self.segments.shape)

    def scatter_master_from_unpadded(self, unpadded, out):
        """Write the 1-D unpadded fp32 ``unpadded`` into ``out``, a
        buffer in this layout on the engine's device or on the host (this
        rank's rows of it when partitioned), padding zero (the JAX coordinator's
        ``scatter_master_from_unpadded``, in place).  Returns ``out``."""
        full = self.storage_from_canonical(self.repad_unpadded(unpadded))
        with torch.no_grad():
            out.copy_(torch.from_numpy(
                full[self.row0:self.row0 + self.shard_rows]))
        return out
