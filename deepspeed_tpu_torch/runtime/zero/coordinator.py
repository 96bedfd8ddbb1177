"""The flat fp32 master and its views (port of
``deepspeed_tpu/runtime/zero/coordinator.py``: ``flatten_to_master``,
``unflatten_params``, ``gather_master_unpadded``).

Every parameter lives in one ``(rows, LANES)`` fp32 buffer in the
row-aligned layout of :func:`~deepspeed_tpu_torch.ops.op_common.build_segments`,
leaves in the JAX package's order (dict keys sorted), so a flat buffer,
and the unpadded 1-D checkpoint form, mean the same in both packages.
This slice runs ZeRO stages 0, 1 and 2 at one data-parallel rank, where
master, optimizer state and gradients are all one unsharded buffer each;
sharding them over ``torch.distributed`` ranks is ROADMAP A5, stage 3 is
A8 and host offload A9.
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
        format)."""
        host = master.detach().float().cpu().numpy().reshape(-1)
        return np.concatenate(
            [host[ro * LANES:ro * LANES + n] for ro, n in
             zip(self.segments.row_offsets, self.segments.sizes)]
            or [np.zeros((0,), np.float32)])
