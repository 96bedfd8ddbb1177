"""Row-sparse (CSR-like) gradients (port of
``deepspeed_tpu/runtime/csr_tensor.py``).

The reference's ``CSRTensor`` (``deepspeed/runtime/csr_tensor.py:11-58``)
for sparse embedding gradients: the engine's ``sparse_gradients``
exchange sends a declared embedding's touched rows as ``(indices,
values)`` through an ``all_gather`` instead of all-reducing every row.
"""

from typing import NamedTuple

import numpy as np
import torch

from .. import comm


class CSRTensor(NamedTuple):
    """Row-sparse view of a [rows, cols] tensor: ``indices[i]`` is the row
    id of ``values[i]``.  ``indices`` may contain duplicates (they add)
    and padding entries marked with ``rows`` (out of range: dropped)."""

    indices: torch.Tensor  # int32 [nnz]
    values: torch.Tensor   # [nnz, cols]
    dense_shape: tuple     # (rows, cols)

    @classmethod
    def from_dense(cls, dense, max_rows=None, return_dropped=False):
        """Compress a dense [rows, cols] tensor with few non-zero rows into
        a fixed budget of ``max_rows`` (default: all rows, no
        compression).  A budget smaller than the support keeps the
        ``max_rows`` rows of most mass and DROPS the rest;
        ``return_dropped=True`` also returns how many non-zero rows did
        not fit (a 0-d int32 tensor), so a caller can detect it."""
        rows, cols = dense.shape
        k = max_rows or rows
        norms = dense.abs().sum(dim=1)
        _, idx = torch.topk(norms, k)
        vals = dense[idx]
        # an all-zero kept row is padding, so no duplicate of row 0 arises
        kept_nz = vals.abs().sum(dim=1) > 0
        pad = torch.where(kept_nz, idx.to(torch.int32),
                          torch.full_like(idx, rows, dtype=torch.int32))
        csr = cls(indices=pad, values=vals, dense_shape=(rows, cols))
        if return_dropped:
            dropped = (norms > 0).sum() - kept_nz.sum()
            return csr, dropped.to(torch.int32)
        return csr

    def to_dense(self):
        rows, cols = self.dense_shape
        out = self.values.new_zeros((rows + 1, cols))
        out.index_add_(0, self.indices.clamp(0, rows).long(), self.values)
        return out[:rows]

    @property
    def nnz(self):
        return self.indices.shape[0]

    def sparsity(self):
        rows, _ = self.dense_shape
        return 1.0 - self.nnz / max(rows, 1)


def csr_allreduce(csr, axis_name, mesh=None):
    """Sum a row-sparse gradient across ``axis_name`` and return the DENSE
    result (the same on every rank): each rank's ``(indices, values)``
    go through an ``all_gather`` (the reference's padded all_gather,
    ``engine.py:1203-1241``) and the union scatter-adds into the dense
    buffer.  Wire bytes are ``nnz x cols`` a rank instead of ``rows x
    cols``."""
    all_idx = comm.all_gather(csr.indices, axis_name, tiled=True, mesh=mesh)
    all_val = comm.all_gather(csr.values, axis_name, tiled=True, mesh=mesh)
    return CSRTensor(indices=all_idx, values=all_val,
                     dense_shape=csr.dense_shape).to_dense()


def csr_allreduce_reference(csrs):
    """Host ground truth: dense sum of per-rank CSR tensors."""
    return np.sum([c.to_dense().cpu().numpy() for c in csrs], axis=0)
