"""Named mesh axes over the ``torch.distributed`` world, and the
Megatron-style ``mpu`` facade (port of ``deepspeed_tpu/parallel/mesh.py``).

The JAX package's mesh is a ``jax.sharding.Mesh`` of devices in one
program; collectives name an axis and XLA routes them.  Here each rank
is one process with one device, so a :class:`Mesh` is the axis sizes,
this rank's coordinates on them (:class:`~deepspeed_tpu_torch.parallel.topology.ProcessTopology`'s
row-major layout) and one process group per axis; the verbs of
:mod:`deepspeed_tpu_torch.comm` name an axis and run on its group.

Canonical axes, outermost first: ``pipe``, ``data``, ``seq``, ``model``,
``expert``.  ``data`` is the ZeRO axis and the one this port runs above
size 1; ``model``, ``seq`` and ``expert`` (tensor, sequence and expert
parallelism) are ROADMAP A10 and ``pipe`` is A13, refused above 1.
"""

import contextlib

import torch.distributed as dist

from ..utils.distributed import get_rank, get_world_size
from .topology import ProcessTopology

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
EXPERT_AXIS = "expert"

CANONICAL_AXES = (PIPE_AXIS, DATA_AXIS, SEQ_AXIS, MODEL_AXIS, EXPERT_AXIS)
# the ROADMAP item that ports each axis other than data
UNPORTED_AXES = {PIPE_AXIS: "A13", SEQ_AXIS: "A10", MODEL_AXIS: "A10",
                 EXPERT_AXIS: "A10"}


def refuse_unported_axes(sizes):
    """Raise for an axis other than ``data`` above size 1, naming its
    ROADMAP item."""
    for ax, item in UNPORTED_AXES.items():
        if int(sizes.get(ax, 1)) > 1:
            raise NotImplementedError(
                f"mesh axis {ax!r} of size {sizes[ax]} is not ported yet "
                f"(ROADMAP {item}); the port runs data parallelism only")


class Mesh:
    """The axis sizes (``shape``, a dict in canonical order), this rank's
    place on them and one process group per axis (``group(axis)``: None
    where the axis has no process group, a world of one process without
    ``torch.distributed``, whose collectives are identities)."""

    def __init__(self, dims, groups=None, rank=0):
        for ax in dims:
            if ax not in CANONICAL_AXES:
                raise ValueError(f"unknown mesh axis {ax!r}; canonical axes "
                                 f"are {CANONICAL_AXES}")
        self.axis_names = CANONICAL_AXES
        self.shape = {ax: int(dims.get(ax, 1)) for ax in CANONICAL_AXES}
        self._groups = dict(groups or {})
        self.rank = rank
        self.topology = ProcessTopology(
            axes=list(CANONICAL_AXES),
            dims=[self.shape[ax] for ax in CANONICAL_AXES])

    @classmethod
    def from_mpu(cls, mpu):
        """The data-parallel mesh of a Megatron-style ``mpu`` whose
        ``get_data_parallel_group()`` is a process group (a
        :class:`MeshGrid` carries its mesh already)."""
        if isinstance(mpu, MeshGrid):
            return mpu.mesh
        refuse_unported_axes(
            {MODEL_AXIS: mpu.get_model_parallel_world_size()})
        return cls({DATA_AXIS: mpu.get_data_parallel_world_size()},
                   groups={DATA_AXIS: mpu.get_data_parallel_group()},
                   rank=mpu.get_data_parallel_rank())

    def size(self, axis):
        return self.shape[axis]

    def group(self, axis):
        return self._groups.get(axis)

    def index(self, axis):
        """This rank's coordinate on ``axis``."""
        return getattr(self.topology.get_coord(self.rank), axis)

    def __repr__(self):
        return f"Mesh({mesh_axis_sizes(self, keep_trivial=True)}, " \
               f"rank={self.rank})"


def data_parallel_process_info(mesh):
    """``(world, rank)`` for per-process batch slicing: the size of the
    ``data`` axis and this process's coordinate on it (every process of
    the port is one data coordinate)."""
    return mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)


# The current mesh, which the losses' global normalisers read
# (:func:`deepspeed_tpu_torch.comm.data_parallel_mean_count`): set only
# inside an engine's own forward and eval calls (:func:`current_mesh`),
# which every rank makes, so a loss computed outside them (one rank's
# evaluation, a user's metric) issues no collective.
_CURRENT_MESH = None


@contextlib.contextmanager
def current_mesh(mesh):
    """Make ``mesh`` the current mesh inside the block, and restore the
    one before it after."""
    global _CURRENT_MESH
    prev, _CURRENT_MESH = _CURRENT_MESH, mesh
    try:
        yield mesh
    finally:
        _CURRENT_MESH = prev


def get_current_mesh():
    return _CURRENT_MESH


def mesh_axis_sizes(mesh, keep_trivial=False):
    """{axis_name: size}; size-1 axes dropped unless ``keep_trivial``."""
    if keep_trivial:
        return dict(mesh.shape)
    return {ax: n for ax, n in mesh.shape.items() if n > 1}


def make_mesh(axis_dims):
    """A :class:`Mesh` over the ``torch.distributed`` world (one process
    without a process group).  ``axis_dims`` maps axis name to size;
    axes default to 1 and a ``-1`` size is the world size over the rest.
    Every rank must call it (it creates the axes' process groups)."""
    dims = {ax: int(axis_dims.get(ax, 1)) for ax in CANONICAL_AXES}
    for ax in axis_dims:
        if ax not in CANONICAL_AXES:
            raise ValueError(f"unknown mesh axis {ax!r}; canonical axes are "
                             f"{CANONICAL_AXES}")
    refuse_unported_axes(dims)
    world = get_world_size()
    infer = [ax for ax, d in dims.items() if d == -1]
    if len(infer) > 1:
        raise ValueError("only one axis size may be -1")
    known = 1
    for ax, d in dims.items():
        if d != -1:
            known *= d
    if infer:
        if world % known:
            raise ValueError(f"{world} processes are not divisible by "
                             f"{known}")
        dims[infer[0]] = world // known
    elif known != world:
        raise ValueError(f"mesh dims {dims} need {known} processes; the "
                         f"torch.distributed world has {world}")
    mesh = Mesh(dims, rank=get_rank())
    if dist.is_initialized():
        for ax in CANONICAL_AXES:
            if dims[ax] == 1 and ax != DATA_AXIS:
                continue  # nothing to exchange over
            for ranks in mesh.topology.get_axis_comm_lists(ax):
                group = (dist.group.WORLD if len(ranks) == world
                         else dist.new_group(ranks))
                if mesh.rank in ranks:
                    mesh._groups[ax] = group
    return mesh


class MeshGrid:
    """Megatron-``mpu``-compatible facade over a :class:`Mesh` (the JAX
    package's ``MeshGrid``, ``mesh.py:156-226``): the
    ``get_{model,data,pipe}_parallel_{rank,group,world_size}()`` surface
    the reference engine reads from a user ``mpu``.  "Group" accessors
    return the axis NAME, which the verbs of
    :mod:`deepspeed_tpu_torch.comm` take."""

    def __init__(self, mesh, topology=None, process_rank=None):
        self.mesh = mesh
        shape = mesh.shape
        self.data_parallel_size = shape.get(DATA_AXIS, 1)
        self.model_parallel_size = shape.get(MODEL_AXIS, 1)
        self.seq_parallel_size = shape.get(SEQ_AXIS, 1)
        self.pipe_parallel_size = shape.get(PIPE_AXIS, 1)
        if topology is None:
            topology = mesh.topology
        self._topo = topology
        self.global_rank = mesh.rank if process_rank is None \
            else process_rank
        self.world_size = topology.world_size()

    @property
    def topology(self):
        return self._topo

    def _coord(self):
        return self._topo.get_coord(self.global_rank)

    # ---- Megatron mpu interface (reference topology.py:405-455) ----
    def get_global_rank(self):
        return self.global_rank

    def get_model_parallel_rank(self):
        return getattr(self._coord(), MODEL_AXIS, 0) \
            if MODEL_AXIS in self._topo.axes else 0

    def get_model_parallel_world_size(self):
        return self.model_parallel_size

    def get_model_parallel_group(self):
        return MODEL_AXIS

    def get_data_parallel_rank(self):
        return getattr(self._coord(), DATA_AXIS, 0) \
            if DATA_AXIS in self._topo.axes else 0

    def get_data_parallel_world_size(self):
        return self.data_parallel_size

    def get_data_parallel_group(self):
        return DATA_AXIS

    # ---- pipeline extras (reference PipelineParallelGrid) ----
    def get_pipe_parallel_rank(self):
        return getattr(self._coord(), PIPE_AXIS, 0) \
            if PIPE_AXIS in self._topo.axes else 0

    def get_pipe_parallel_world_size(self):
        return self.pipe_parallel_size

    def get_pipe_parallel_group(self):
        return PIPE_AXIS

    def get_stage_id(self):
        return self.get_pipe_parallel_rank()

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self.pipe_parallel_size - 1
