"""The bucketed layout of ZeRO's gradient exchange under ``overlap_comm``
(port of ``deepspeed_tpu/runtime/zero/buckets.py:60-266``).

The flat parameter space splits into **leaf-aligned buckets** of at most
``reduce_bucket_size`` elements, each padded to a multiple of the
data-parallel degree ``dp``.  The engine reduce-scatters each bucket on
its own as soon as the backward has produced its last leaf's gradient
(the reference's ``stage2.py:583-738``), and all-gathers the master in
``ag_groups`` of consecutive buckets under ``allgather_bucket_size``.

A per-bucket reduce-scatter hands rank ``r`` the ``r``-th piece of every
bucket, so the master and the optimizer state store their rows in
**shard-major order**::

    [rank 0: bucket 0 piece 0, bucket 1 piece 0, ...]
    [rank 1: bucket 0 piece 1, bucket 1 piece 1, ...]

and each rank's contiguous rows are its piece of every bucket.  The
compute params and the gradient keep the **canonical** plan layout
(buckets one after another, each bucket's leaves row-aligned, as
:attr:`segments` gives them).  Checkpoints stay canonical and unpadded
(:meth:`gather_unpadded`, :meth:`scatter_unpadded`), so a bucketed engine
and a fused one, at any degree, load each other's files bit for bit.

The layout is plain ints; the data are numpy arrays on the host (the
checkpoint form) or torch tensors on the device (the bucket and group
helpers; :meth:`canonical_from_storage` takes either).
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ...ops.op_common import LANES, Segments


class Bucket(NamedTuple):
    index: int
    leaf_lo: int                       # first leaf index (inclusive)
    leaf_hi: int                       # last leaf index (exclusive)
    rows: int                          # bucket rows, divisible by dp
    piece_rows: int                    # rows // dp (one rank's piece)
    start_row: int                     # first row in the canonical layout
    piece_start: int                   # first row of the piece in a shard
    leaf_row_offsets: Tuple[int, ...]  # within-bucket row offset per leaf
    elements: int                      # true (unpadded) elements covered


class BucketPlan:
    """The bucketed layout of leaves of ``sizes`` elements (in
    ``tree_leaves`` order) over ``dp`` ranks.  A leaf larger than
    ``reduce_bucket_size`` is a bucket of its own; every bucket holds at
    least one leaf."""

    def __init__(self, sizes, dp, reduce_bucket_size,
                 allgather_bucket_size, lanes=LANES):
        self.dp = int(dp)
        self.lanes = int(lanes)
        self.sizes = tuple(int(s) for s in sizes)
        self.reduce_bucket_size = int(reduce_bucket_size)
        self.allgather_bucket_size = int(allgather_bucket_size)
        if self.dp < 1:
            raise ValueError(f"dp must be >= 1, got {dp}")
        row_counts = [-(-s // self.lanes) for s in self.sizes]
        buckets = []
        start_row = piece_start = lo = 0
        n = len(self.sizes)
        while lo < n:
            hi, elems = lo + 1, self.sizes[lo]
            while hi < n and elems + self.sizes[hi] <= self.reduce_bucket_size:
                elems += self.sizes[hi]
                hi += 1
            offs, r = [], 0
            for i in range(lo, hi):
                offs.append(r)
                r += row_counts[i]
            rows = -(-max(r, 1) // self.dp) * self.dp
            buckets.append(Bucket(len(buckets), lo, hi, rows,
                                  rows // self.dp, start_row, piece_start,
                                  tuple(offs), elems))
            start_row += rows
            piece_start += rows // self.dp
            lo = hi
        if not buckets:
            buckets.append(Bucket(0, 0, 0, self.dp, 1, 0, 0, (), 0))
        self.buckets = tuple(buckets)
        self.rows = sum(b.rows for b in self.buckets)
        self.piece_rows = self.rows // self.dp
        self.shape = (self.rows, self.lanes)
        # all-gather groups: consecutive buckets, greedy by element count
        groups, g_lo = [], 0
        while g_lo < len(self.buckets):
            g_hi, elems = g_lo + 1, self.buckets[g_lo].elements
            while (g_hi < len(self.buckets)
                   and elems + self.buckets[g_hi].elements
                   <= self.allgather_bucket_size):
                elems += self.buckets[g_hi].elements
                g_hi += 1
            groups.append((g_lo, g_hi))
            g_lo = g_hi
        self.ag_groups = tuple(groups)
        self.bucket_of_leaf = tuple(b.index for b in self.buckets
                                    for _ in range(b.leaf_lo, b.leaf_hi))

    @property
    def n_buckets(self):
        return len(self.buckets)

    def leaf_rows(self):
        """Per-leaf ``(row_offset, row_count, size)`` in the canonical
        layout."""
        out = []
        for b in self.buckets:
            for k, i in enumerate(range(b.leaf_lo, b.leaf_hi)):
                out.append((b.start_row + b.leaf_row_offsets[k],
                            -(-self.sizes[i] // self.lanes), self.sizes[i]))
        return out

    @property
    def segments(self):
        """The canonical layout as
        :class:`~deepspeed_tpu_torch.ops.op_common.Segments`: where each
        leaf sits in the compute and gradient buffers."""
        table = self.leaf_rows()
        return Segments(row_offsets=tuple(t[0] for t in table),
                        row_counts=tuple(t[1] for t in table),
                        sizes=tuple(t[2] for t in table), rows=self.rows)

    def group_rows(self, g):
        """``(first canonical row, rows, first piece row, piece rows)`` of
        all-gather group ``g``: its buckets are consecutive in both
        layouts."""
        g_lo, g_hi = self.ag_groups[g]
        lo, hi = self.buckets[g_lo], self.buckets[g_hi - 1]
        return (lo.start_row, hi.start_row + hi.rows - lo.start_row,
                lo.piece_start, hi.piece_start + hi.piece_rows
                - lo.piece_start)

    # -- canonical <-> storage permutation -----------------------------
    def storage_from_canonical(self, canon):
        """(rows, lanes) canonical -> shard-major storage order; a pure
        permutation of rows, exact for any dtype."""
        canon = np.asarray(canon).reshape(self.rows, self.lanes)
        parts = [canon[b.start_row:b.start_row + b.rows].reshape(
            self.dp, b.piece_rows, self.lanes) for b in self.buckets]
        return np.concatenate(parts, axis=1).reshape(self.shape)

    def canonical_from_storage(self, storage):
        """Shard-major storage order -> canonical, for a numpy array or a
        tensor (on its device)."""
        cat = torch.cat if isinstance(storage, torch.Tensor) \
            else np.concatenate
        storage = storage.reshape(self.dp, self.piece_rows, self.lanes)
        return cat([storage[:, b.piece_start:b.piece_start + b.piece_rows]
                    .reshape(b.rows, self.lanes) for b in self.buckets])

    # -- checkpoint format (canonical, unpadded, 1-D) -------------------
    def gather_unpadded(self, storage):
        """Storage-order array -> the true-sized 1-D fp32 checkpoint form,
        the same bytes as the fused layout's."""
        flat = self.canonical_from_storage(np.asarray(storage)).astype(
            np.float32, copy=False).reshape(-1)
        parts = [flat[ro * self.lanes:ro * self.lanes + sz]
                 for ro, _, sz in self.leaf_rows()]
        return (np.concatenate(parts) if parts
                else np.zeros((0,), np.float32))

    def scatter_unpadded(self, arr):
        """True-sized 1-D array -> the (rows, lanes) fp32 storage order,
        padding zero."""
        arr = np.asarray(arr, np.float32).reshape(-1)
        canon = np.zeros((self.rows * self.lanes,), np.float32)
        off = 0
        for ro, _, sz in self.leaf_rows():
            canon[ro * self.lanes:ro * self.lanes + sz] = arr[off:off + sz]
            off += sz
        if off != arr.size:
            raise ValueError(f"flat buffer has {arr.size} elements, "
                             f"expected {off}")
        return self.storage_from_canonical(canon)

    # -- device helpers ------------------------------------------------
    def bucket_block_from_leaves(self, leaves, b, dtype):
        """Leaves ``[leaf_lo, leaf_hi)`` of bucket ``b`` (tensors,
        indexed by leaf) -> its canonical ``(rows, lanes)`` block in
        ``dtype``, padding zero."""
        bucket = self.buckets[b]
        ref = leaves[bucket.leaf_lo] if bucket.leaf_hi > bucket.leaf_lo \
            else None
        block = torch.zeros((bucket.rows * self.lanes,), dtype=dtype,
                            device=None if ref is None else ref.device)
        for k, i in enumerate(range(bucket.leaf_lo, bucket.leaf_hi)):
            start = bucket.leaf_row_offsets[k] * self.lanes
            block[start:start + self.sizes[i]] = leaves[i].reshape(-1)
        return block.view(bucket.rows, self.lanes)

    def carve_bucket(self, block, b, shapes, dtype):
        """Bucket ``b``'s canonical block -> its leaves (views where no
        cast is needed), in order; ``shapes`` indexes every leaf."""
        bucket = self.buckets[b]
        flat = block.reshape(-1)
        out = []
        for k, i in enumerate(range(bucket.leaf_lo, bucket.leaf_hi)):
            start = bucket.leaf_row_offsets[k] * self.lanes
            out.append(flat[start:start + self.sizes[i]].view(shapes[i])
                       .to(dtype))
        return out

    def canonical_group(self, full, g, out=None):
        """All-gather group ``g``'s gathered pieces (every rank's rows of
        its buckets, rank after rank) -> the group's canonical rows, in
        ``out`` when given."""
        _, rows, _, prows = self.group_rows(g)
        full = full.reshape(self.dp, prows, self.lanes)
        if out is None:
            out = full.new_empty((rows, self.lanes))
        g_lo, g_hi = self.ag_groups[g]
        row = off = 0
        for b in self.buckets[g_lo:g_hi]:
            out[row:row + b.rows].view(self.dp, b.piece_rows,
                                       self.lanes).copy_(
                full[:, off:off + b.piece_rows])
            row += b.rows
            off += b.piece_rows
        return out

    def schedule(self):
        """The collective schedule's static geometry."""
        return {"rs_buckets": self.n_buckets,
                "ag_buckets": len(self.ag_groups),
                "reduce_bucket_size": self.reduce_bucket_size,
                "allgather_bucket_size": self.allgather_bucket_size,
                "rows": self.rows}
