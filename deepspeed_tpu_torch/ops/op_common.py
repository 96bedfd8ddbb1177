"""Flat-parameter-space helpers and the byte-mask dropout draw (port of
``deepspeed_tpu/ops/op_common.py``).

All parameters of a model live in one fp32 buffer of shape
``(rows, LANES=1024)``; each tensor starts on a row boundary, so
per-tensor views are contiguous row ranges and per-tensor norms are sums
over whole rows.  The port keeps the JAX package's layout (the row
alignment is what the Lamb trust ratios and the checkpoint format rest
on), so a flat buffer means the same thing in both packages.
"""

from typing import Callable, NamedTuple, Tuple

import torch

LANES = 1024


class Segments(NamedTuple):
    """Static map from flat-buffer rows back to parameter tensors."""

    row_offsets: Tuple[int, ...]  # first row of each tensor
    row_counts: Tuple[int, ...]   # rows occupied by each tensor
    sizes: Tuple[int, ...]        # true element count of each tensor
    rows: int                     # total rows including padding

    @property
    def num_segments(self):
        return len(self.sizes)

    @property
    def total(self):
        """Total element capacity of the buffer."""
        return self.rows * LANES

    @property
    def shape(self):
        return (self.rows, LANES)

    def row_segment_ids(self, device=None):
        """int64 [rows] mapping each row to its tensor index; trailing pad
        rows map to ``num_segments``."""
        ids = torch.full((self.rows,), self.num_segments, dtype=torch.int64)
        for i, (ro, rc) in enumerate(zip(self.row_offsets, self.row_counts)):
            ids[ro:ro + rc] = i
        return ids.to(device)


def build_segments(sizes, pad_to=1):
    """Row-aligned segment layout; ``pad_to`` pads the total rows to a
    multiple (the data-parallel shard count)."""
    row_offsets, row_counts = [], []
    row = 0
    for n in sizes:
        rc = -(-n // LANES)
        row_offsets.append(row)
        row_counts.append(rc)
        row += rc
    if pad_to > 1 and row % pad_to != 0:
        row += pad_to - (row % pad_to)
    return Segments(row_offsets=tuple(row_offsets),
                    row_counts=tuple(row_counts), sizes=tuple(sizes),
                    rows=row)


class RowShard(NamedTuple):
    """The rows ``[row0, row0 + rows)`` of the flat buffer that one
    data-parallel rank owns under ZeRO-1/2, and ``reduce``, which sums a
    tensor in place over the ranks that own the rest (a tensor's rows
    can straddle two ranks, so its per-tensor sums are partial)."""

    row0: int
    rows: int
    reduce: Callable


def segment_row_bounds(segments, device=None, shard=None):
    """(first row, one past the last row) of every tensor, as int64
    tensors on ``device``: made once, so a step copies no index to the
    card.  With a :class:`RowShard` they are the tensor's rows inside the
    shard, relative to its first row (empty where it lies outside)."""
    starts = torch.tensor(segments.row_offsets, dtype=torch.int64)
    ends = starts + torch.tensor(segments.row_counts, dtype=torch.int64)
    if shard is not None:
        starts = (starts - shard.row0).clamp(0, shard.rows)
        ends = (ends - shard.row0).clamp(0, shard.rows)
    return starts.to(device), ends.to(device)


def segment_sq_sums_rows(flat, segments, bounds=None):
    """Per-tensor sums of squares (float64) of the (rows, LANES) buffer,
    using the row alignment (every tensor owns whole rows; intra-row
    tail padding is zero).  One lane-axis reduction, then each tensor's
    rows summed as a difference of one float64 prefix sum: no scatter,
    no atomics, the same answer every run, and a fixed handful of
    kernels however many tensors there are (the JAX package sums a
    static slice per tensor).  ``bounds`` is :func:`segment_row_bounds`
    on ``flat``'s device; with a :class:`RowShard`'s bounds the sums are
    over the shard's rows only."""
    starts, ends = (bounds if bounds is not None
                    else segment_row_bounds(segments, flat.device))
    row_sq = flat.float().square().sum(dim=1)
    prefix = torch.cat([row_sq.new_zeros(1, dtype=torch.float64),
                        row_sq.double().cumsum(0)])
    return prefix[ends] - prefix[starts]


def sq_sums_to_norms(sq):
    return sq.clamp_min(0.0).sqrt().float()


def segment_l2_norms_rows(flat, segments, bounds=None):
    """Per-tensor L2 norms of the (rows, LANES) buffer: the roots of
    :func:`segment_sq_sums_rows`."""
    return sq_sums_to_norms(segment_sq_sums_rows(flat, segments, bounds))


def random_keep(generator, shape, rate, device=None):
    """Inverted-dropout keep mask and scale from ONE random byte per
    element: the drop rate is quantized to ``round(rate * 256) / 256``
    and the scale ``256 / (256 - thresh)`` is exactly unbiased for it
    (``E[keep * scale] == 1``).  The bytes come from ``generator`` (a
    ``torch.Generator`` on ``device``).  Returns ``(keep_mask_bool,
    scale_float)``."""
    thresh = min(255, max(1, int(round(float(rate) * 256.0))))
    bits = torch.randint(0, 256, tuple(shape), dtype=torch.uint8,
                         generator=generator, device=device)
    return bits >= thresh, 256.0 / (256 - thresh)
