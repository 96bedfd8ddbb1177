"""N-dimensional parallelism topology (port of
``deepspeed_tpu/parallel/topology.py``, pure Python, copied).

The rank <-> coordinate bookkeeping of the reference's
``ProcessTopology`` (reference ``topology.py:12-233``): ranks are laid
out in row-major order over named axes, outermost first, so the last
axis varies fastest.  :func:`~deepspeed_tpu_torch.parallel.mesh.make_mesh`
builds one ``torch.distributed`` process group per axis from
:meth:`ProcessTopology.get_axis_comm_lists`.
"""

from collections import namedtuple
from itertools import product


class ProcessTopology:
    """Cartesian coordinate mapper over named axes (reference ``topology.py:12``).

    ``axes`` is ordered outermost-first; ``dims`` are the axis sizes.  Ranks
    are assigned in row-major (C) order, so the last axis varies fastest.
    """

    def __init__(self, axes, dims):
        self.axes = list(axes)
        self.dims = list(dims)
        self.ProcessCoord = namedtuple("ProcessCoord", self.axes)
        self.mapping = {}
        ranges = [range(d) for d in self.dims]
        for global_rank, coord in enumerate(product(*ranges)):
            key = dict(zip(self.axes, coord))
            self.mapping[self.ProcessCoord(**key)] = global_rank

    def get_rank(self, **coord_kwargs):
        if len(coord_kwargs) != len(self.axes):
            raise ValueError("get_rank() does not support slices")
        key = self.ProcessCoord(**coord_kwargs)
        assert key in self.mapping, f"coord {key} not found in topology"
        return self.mapping[key]

    def get_axis_names(self):
        return self.axes

    def get_rank_repr(self, rank, omit_axes=("data", "pipe"), inner_sep="_", outer_sep="-"):
        """String form of a rank's non-omitted coordinates, used in checkpoint
        filenames (reference ``topology.py:80-108``)."""
        omit_axes = list(omit_axes)
        axes = [a for a in self.get_axis_names() if a not in omit_axes]
        names = []
        for ax in axes:
            ax_rank = getattr(self.get_coord(rank=rank), ax)
            names.append(f"{ax}{inner_sep}{ax_rank:02d}")
        return outer_sep.join(names)

    def get_dim(self, axis):
        if axis not in self.axes:
            return 0
        return self.dims[self.axes.index(axis)]

    def get_coord(self, rank):
        for coord, idx in self.mapping.items():
            if idx == rank:
                return coord
        raise ValueError(f"rank {rank} not found in topology.")

    def get_axis_comm_lists(self, axis):
        """Lists of ranks that communicate along ``axis`` (reference ``:131-169``).

        Each list holds ranks differing only in their ``axis`` coordinate —
        exactly the members of one process group in the reference; here it
        defines mesh sub-axes and checkpoint shard groupings.
        """
        if axis not in self.axes:
            return []
        other_axes = [a for a in self.axes if a != axis]
        lists = []
        ranges = [range(self.get_dim(a)) for a in other_axes]
        for coord in product(*ranges):
            other_keys = dict(zip(other_axes, coord))
            sub_list = [
                self.mapping[self.ProcessCoord(**other_keys, **{axis: axis_key})]
                for axis_key in range(self.get_dim(axis))
            ]
            lists.append(sub_list)
        return lists

    def filter_match(self, **filter_kwargs):
        """All ranks whose coordinates match the given axis=value filters
        (reference ``:171-199``)."""

        def _filter_helper(x):
            for key, val in filter_kwargs.items():
                if getattr(x, key) != val:
                    return False
            return True

        coords = filter(_filter_helper, self.mapping.keys())
        return [self.mapping[coord] for coord in coords]

    def get_axis_list(self, axis, idx):
        """Ranks whose ``axis`` coordinate equals ``idx`` (reference ``:201-217``)."""
        return [rank for coord, rank in self.mapping.items() if getattr(coord, axis) == idx]

    def world_size(self):
        size = 1
        for d in self.dims:
            size *= d
        return size

    def __str__(self):
        return str(self.mapping)


class PipeDataParallelTopology(ProcessTopology):
    """pipe × data hybrid (reference ``topology.py:235-244``)."""

    def __init__(self, num_pp, num_dp):
        super().__init__(axes=["pipe", "data"], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """pipe × data × model 3D hybrid (reference ``topology.py:246-249``).

    ``model`` is innermost so tensor-parallel collectives use adjacent chips.
    """

    def __init__(self, num_pp, num_mp, num_dp):
        super().__init__(axes=["pipe", "data", "model"], dims=[num_pp, num_dp, num_mp])
