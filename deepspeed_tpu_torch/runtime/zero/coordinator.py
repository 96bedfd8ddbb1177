"""The flat fp32 master and its views (port of
``deepspeed_tpu/runtime/zero/coordinator.py``: ``flatten_to_master``,
``unflatten_params``, ``gather_master_unpadded`` and its inverses
``repad_unpadded`` / ``scatter_master_from_unpadded``, ``:512``, ``:528``).

Every parameter lives in one ``(rows, LANES)`` fp32 buffer in the
row-aligned layout of :func:`~deepspeed_tpu_torch.ops.op_common.build_segments`,
leaves in the JAX package's order (dict keys sorted), so a flat buffer,
and the unpadded 1-D checkpoint form, mean the same in both packages.
The engine's flat compute and gradient buffers take the same layout in
the compute dtype (bf16, fp16 or fp32): :meth:`unflatten_params` gives
the param dict's views of any of them, and the compute buffer is the
master's cast, one copy.
This slice runs ZeRO stages 0, 1 and 2 at one data-parallel rank, where
master, optimizer state and gradients are all one unsharded buffer each;
sharding them over ``torch.distributed`` ranks is ROADMAP A5 and stage 3
is A8.

Under ``cpu_offload`` (JAX ``coordinator.py:225-242``, ``:352-380``) the
master and the optimizer state are host buffers in their storage dtype,
one per family (:meth:`host_buffer`, :meth:`flatten_to_host`,
:meth:`alloc_host_grads`): pinned when the engine trains on the card,
allocated pinned and filled in place (pinning a filled tensor would
hold two copies), plain CPU tensors when it trains on the CPU.  The
JAX package splits them into row groups under XLA's per-host-buffer
bound; the port has no such bound and keeps one group.
"""

import numpy as np
import torch

from ...ops.op_common import LANES, build_segments
from ...utils.params import tree_from_leaves, tree_leaves


class FlatParamCoordinator:
    def __init__(self, params_template, stage=0, dp_size=1):
        if dp_size != 1:
            raise NotImplementedError(
                "data parallelism over torch.distributed is not ported yet "
                "(ROADMAP A5); the engine runs at one data-parallel rank")
        if stage >= 3:
            raise NotImplementedError("ZeRO stage 3 is not ported yet "
                                      "(ROADMAP A8)")
        self.stage = stage
        self.dp_size = dp_size
        self.paths, leaves = tree_leaves(params_template)
        self.shapes = [tuple(np.shape(leaf)) for leaf in leaves]
        sizes = [int(np.prod(shape)) for shape in self.shapes]
        self.segments = build_segments(sizes,
                                       pad_to=dp_size if stage >= 1 else 1)

    @property
    def flat_shape(self):
        return self.segments.shape

    def flatten_to_master(self, params, device):
        """The ``(rows, LANES)`` fp32 master on ``device``, filled leaf by
        leaf on the host (numpy or tensor leaves; padding zero)."""
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
        return torch.from_numpy(host.reshape(self.segments.shape)).to(device)

    def host_buffer(self, dtype, pin):
        """A zero host buffer in the flat layout (``pin``: page-locked,
        for copies to and from the card without a staging copy)."""
        return torch.zeros(self.flat_shape, dtype=dtype, pin_memory=pin)

    def flatten_to_host(self, params, dtype, pin):
        """The master as a host buffer in storage ``dtype``, allocated
        once and filled leaf by leaf in place (a cast to bf16 rounds to
        nearest, as numpy's ``astype`` does in the JAX package)."""
        _, leaves = tree_leaves(params)
        if len(leaves) != self.segments.num_segments:
            raise ValueError(f"the tree has {len(leaves)} leaves but the "
                             f"layout was built for "
                             f"{self.segments.num_segments}")
        host = self.host_buffer(dtype, pin)
        flat = host.view(-1)
        with torch.no_grad():
            for leaf, ro, n in zip(leaves, self.segments.row_offsets,
                                   self.segments.sizes):
                src = (leaf.detach().float().cpu()
                       if isinstance(leaf, torch.Tensor)
                       else torch.from_numpy(np.asarray(leaf, np.float32)))
                flat[ro * LANES:ro * LANES + n].copy_(src.reshape(-1))
        return host

    def alloc_host_grads(self, pin):
        """The fp32 host gradient buffer of ``offload_gradients``."""
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

    def gather_master_unpadded(self, master):
        """Concatenated true-sized 1-D fp32 host copy (checkpoint
        format) of ``master`` or any buffer in its layout: the segments
        are gathered on the buffer's device, then copied to the host
        once (a host buffer's are read where they are, with no round
        trip through the card; a bf16 one is upcast exactly).  The array
        owns its memory: no later step writes it."""
        view = master.detach().reshape(-1)
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
        buffer in this layout on the engine's device, padding zero (the
        JAX coordinator's ``scatter_master_from_unpadded``, in place).
        Returns ``out``."""
        with torch.no_grad():
            out.copy_(torch.from_numpy(self.repad_unpadded(unpadded)))
        return out
