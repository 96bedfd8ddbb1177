"""Named mesh axes over the ``torch.distributed`` world, and the
Megatron-style ``mpu`` facade (port of ``deepspeed_tpu/parallel/mesh.py``).

The JAX package's mesh is a ``jax.sharding.Mesh`` of devices in one
program; collectives name an axis and XLA routes them.  Here each rank
is one process with one device, so a :class:`Mesh` is the axis sizes,
this rank's coordinates on them (:class:`~deepspeed_tpu_torch.parallel.topology.ProcessTopology`'s
row-major layout) and one process group per axis; the verbs of
:mod:`deepspeed_tpu_torch.comm` name an axis and run on its group.

Canonical axes, outermost first: ``pipe``, ``data``, ``seq``, ``model``,
``expert``.  ``data`` is the ZeRO axis and ``pipe`` the pipeline's: the
port runs both above size 1, in the reference's rank order (``pipe``
outermost, so the ranks of one stage are consecutive:
:class:`~deepspeed_tpu_torch.parallel.topology.PipeDataParallelTopology`).
A ``pipe`` × ``data`` mesh has one process group per pipe column (the
stages of one data coordinate), one data group per stage, and one over
both axes (``group((PIPE_AXIS, DATA_AXIS))``), which the pipeline
engine's one scalar all-reduce a step runs on.  ``model`` (Megatron
tensor parallelism) and ``expert`` (expert parallelism) run above 1
too: every process group over a set of two or more axes above size 1
is made with the mesh (``group(("model", "expert"))``, ``group(("data",
"model", "expert"))``, ...), so the engine's one stats all-reduce and
the MoE layer's regions over both axes have theirs.  ``seq`` (sequence
parallelism) runs above 1 too: the ranks of one ``seq`` group hold the
chunks of one data coordinate's sequences, and ring attention
(:mod:`~deepspeed_tpu_torch.ops.transformer.ring_attention`) rotates the
keys and values over it; the groups over ``(data, seq)``, ``(seq,
model)`` and ``(data, seq, model)`` are made with the others.
"""

import contextlib
import itertools

import torch.distributed as dist

from ..utils.distributed import get_rank, get_world_size
from .topology import ProcessTopology

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
EXPERT_AXIS = "expert"

CANONICAL_AXES = (PIPE_AXIS, DATA_AXIS, SEQ_AXIS, MODEL_AXIS, EXPERT_AXIS)


def _axes_key(axis):
    """An axis name, or a tuple of them in canonical order."""
    if isinstance(axis, (tuple, list)):
        return tuple(ax for ax in CANONICAL_AXES if ax in axis)
    return axis


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
        """The ``data`` × ``model`` mesh of a Megatron-style ``mpu`` whose
        ``get_data_parallel_group()`` and ``get_model_parallel_group()``
        are process groups (a :class:`MeshGrid` carries its mesh
        already).  The ranks are laid out as the reference's mpu lays
        them out, ``model`` innermost; above one member on both axes the
        two axes must cover the whole world, whose group is then the
        stats group over both."""
        if isinstance(mpu, MeshGrid):
            return mpu.mesh
        dp = mpu.get_data_parallel_world_size()
        mp = mpu.get_model_parallel_world_size()
        groups = {DATA_AXIS: mpu.get_data_parallel_group()}
        rank = mpu.get_data_parallel_rank() * mp
        if mp > 1:
            groups[MODEL_AXIS] = mpu.get_model_parallel_group()
            rank += mpu.get_model_parallel_rank()
            if dp > 1:
                if dp * mp != get_world_size():
                    raise ValueError(
                        f"an mpu with data {dp} x model {mp} needs a world "
                        f"of {dp * mp} processes, not {get_world_size()}")
                groups[(DATA_AXIS, MODEL_AXIS)] = dist.group.WORLD
        return cls({DATA_AXIS: dp, MODEL_AXIS: mp}, groups=groups,
                   rank=rank)

    def size(self, axis):
        """The size of an axis, or of a tuple of axes (their product)."""
        key = _axes_key(axis)
        if isinstance(key, tuple):
            n = 1
            for ax in key:
                n *= self.shape[ax]
            return n
        return self.shape[key]

    def group(self, axis):
        """The process group of an axis, or of a tuple of axes (the
        ranks that differ only in those coordinates; the axes of size 1
        in it are dropped, so a tuple names the group of its axes above
        one member, None where none is)."""
        key = _axes_key(axis)
        if isinstance(key, tuple):
            key = tuple(ax for ax in key if self.shape[ax] > 1)
            if not key:
                return None
            if len(key) == 1:
                key = key[0]
        return self._groups.get(key)

    def index(self, axis):
        """This rank's coordinate on ``axis``."""
        return getattr(self.topology.get_coord(self.rank), axis)

    def peer(self, axis, index):
        """The global rank at coordinate ``index`` of ``axis``, every
        other coordinate this rank's."""
        coord = self.topology.get_coord(self.rank)._asdict()
        coord[axis] = index
        return self.topology.get_rank(**coord)

    def __repr__(self):
        return f"Mesh({mesh_axis_sizes(self, keep_trivial=True)}, " \
               f"rank={self.rank})"


def data_parallel_process_info(mesh):
    """``(world, rank)`` for per-process batch slicing: the size of the
    ``data`` axis and this process's coordinate on it.  Every process is
    one data coordinate, and the ``seq`` (and ``model``) ranks of one
    data coordinate get the same rows: a sequence-parallel model cuts its
    own chunk of each row."""
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


# True inside a block where every ``seq`` rank holds the whole sequence,
# not its chunk (the pipeline engine's last stage gathers its output for
# ``loss_fn``): the losses' normalisers then count over ``data`` alone
_WHOLE_SEQUENCE = False


@contextlib.contextmanager
def whole_sequence():
    """Every ``seq`` rank holds the whole sequence inside the block."""
    global _WHOLE_SEQUENCE
    prev, _WHOLE_SEQUENCE = _WHOLE_SEQUENCE, True
    try:
        yield
    finally:
        _WHOLE_SEQUENCE = prev


def sequence_is_whole():
    return _WHOLE_SEQUENCE


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
            _add_groups(mesh, ax, mesh.topology.get_axis_comm_lists(ax),
                        world)
        # every set of two or more axes above size 1, in canonical order
        big = [ax for ax in CANONICAL_AXES if dims[ax] > 1]
        for n in range(2, len(big) + 1):
            for axes in itertools.combinations(big, n):
                _add_groups(mesh, axes, _comm_lists(mesh.topology, axes),
                            world)
    return mesh


def _add_groups(mesh, key, rank_lists, world):
    """One process group per list (every rank creates every group, as
    ``new_group`` requires); this rank's is the mesh's group ``key``."""
    for ranks in rank_lists:
        group = (dist.group.WORLD if len(ranks) == world
                 else dist.new_group(ranks))
        if mesh.rank in ranks:
            mesh._groups[key] = group


def _comm_lists(topology, axes):
    """Lists of ranks that differ only in their coordinates on ``axes``
    (``get_axis_comm_lists`` over several axes), each in rank order."""
    lists = {}
    for coord, rank in topology.mapping.items():
        rest = tuple(getattr(coord, ax) for ax in topology.axes
                     if ax not in axes)
        lists.setdefault(rest, []).append(rank)
    return [sorted(ranks) for _, ranks in sorted(lists.items())]


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
        self.expert_parallel_size = shape.get(EXPERT_AXIS, 1)
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

    def get_expert_parallel_rank(self):
        return getattr(self._coord(), EXPERT_AXIS, 0) \
            if EXPERT_AXIS in self._topo.axes else 0

    def get_expert_parallel_world_size(self):
        return self.expert_parallel_size

    def get_expert_parallel_group(self):
        return EXPERT_AXIS

    def get_seq_parallel_rank(self):
        return getattr(self._coord(), SEQ_AXIS, 0) \
            if SEQ_AXIS in self._topo.axes else 0

    def get_seq_parallel_world_size(self):
        return self.seq_parallel_size

    def get_seq_parallel_group(self):
        return SEQ_AXIS

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
