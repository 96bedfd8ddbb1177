"""Pipeline-parallel engine: one stage a process, each running its
instruction stream (port of ``deepspeed_tpu/runtime/pipe/engine.py``:
``PipelineEngine`` ``:276-421``, ``train_batch`` ``:360-404``,
``eval_batch`` ``:406-412``, ``schedule_trace`` ``:414-421``).

The JAX package compiles a whole batch into one SPMD program: a
``lax.scan`` over the fill-drain ticks with ``ppermute`` between stages,
autodiff for the backward, every device tracing the whole tree.  The
port takes the design the JAX package keeps as its description
(``schedule.py``): each rank of the mesh's ``pipe`` axis builds and
holds only its stage's layers, plus its own copy of each tied param
those layers use, and walks its schedule, executing every instruction:

- ``LoadMicroBatch``: the next micro-batch of ``data_iter``, its inputs
  on the first stage and its labels on the last (only those two stages
  draw from the iterator);
- ``ForwardPass`` / ``BackwardPass``: the stage's layers
  (``apply_range``), the loss on the last stage, the backward of the
  scaled loss there and of the received activation gradients
  elsewhere, each micro-batch's gradient summed into the flat gradient
  buffer (the base engine's accumulation and ZeRO-2 exchange);
- ``Send/RecvActivation`` and ``Send/RecvGrad``: point-to-point on the
  ``pipe`` axis (:func:`~deepspeed_tpu_torch.comm.send_recv`), the
  consecutive transfers of a step posted together.  The first
  activation across each stage boundary of a ``train_batch`` or
  ``eval_batch`` goes with a small metadata tensor (count, dtypes and
  shapes of its tensors) ahead of it: the receiver sizes the buffers of
  every micro-batch of the batch from it, so a stage boundary may be a
  tuple of tensors, and the later transfers go without metadata or a
  host sync;
- ``ReduceTiedGrads``: each tied param's gradient all-reduced over the
  stages that hold a copy (reference ``module.py:405-418``), before the
  data-parallel exchange;
- ``ReduceGrads`` and ``OptimizerStep``: the base engine's step.  Its one
  scalar all-reduce runs over the ``pipe`` and ``data`` axes, so every
  stage skips the same fp16 step and clips by one global norm, in which
  a tied param counts once (on the stage that holds its owning layer),
  and every rank returns the last stage's mean loss (JAX ``:259``).

The schedule is the 1F1B :class:`TrainSchedule` at ``interleave`` 1.
With ``interleave`` v > 1 the layers split into ``stages × v`` logical
stages, logical stage ``l`` on rank ``l % stages``, run in the JAX
program's tick order (``engine.py:215-259``): every forward tick in
turn, then every backward tick in reverse (fill-drain, so all
``v × micro_batches`` activations of a rank are in flight at once, as
in the JAX program).  At one stage the engine is the JAX package's
degenerate case, gradient accumulation over the micro-batches
(:class:`DataParallelSchedule`, JAX ``:103-113``).

The JAX engine sets ``_grad_divisor`` to 1 (``:290``): its pipelined
loss is already the mean over the micro-batches.  Here the last stage
backpropagates each micro-batch's loss divided by ``micro_batches ×
dp`` (the base engine's ``_scaled_loss``), the same mean, and one
``train_batch`` adds ``micro_batches`` to ``micro_steps`` and their
samples to ``global_samples`` (``:380-385``).

Dropout draws one stream per (micro-batch, logical stage) from the
step's seed (JAX ``:237-241``), per micro-batch alone at one stage
(``:104-106``), and the data-parallel rank's above rank 0.  The math is
the JAX engine's: the mean loss over the micro-batches, the tied
gradient summed over its uses, the global-norm clip, the fp16 skip;
only the order of the sums differs.

Pipe × model × data (JAX ``PipeModelDataParallelTopology``): a stage's
layers are Megatron shards over the mesh's ``model`` axis (the layers'
``partition_specs``), point-to-point between stages pairs ranks of
equal model coordinate (each model rank sends its own copy of the
boundary activation), a tied param's copies are summed over the stages
of one data and model coordinate, and the step's stats all-reduce runs
over ``pipe``, ``data`` and ``model``.  MoE blocks under the pipeline
engine (the ``expert`` axis) raise: the JAX package has no such path
(``MOE_PIPE_ITEM``).

Pipe × seq: a stage's ``seq`` ranks hold chunks of the sequence: the
first stage cuts its chunk of the micro-batch's inputs (dim 1, rank r
of N positions ``[r·s/N, (r+1)·s/N)``), and the layers run on the
chunk, so each must declare ``seq_parallel`` (per position, or the
port's attention cores over the axis under the current mesh: see
:mod:`.module`); a module with one that does not is refused
(``SEQ_MODEL_ITEM``).  Point-to-point pairs the ranks of equal ``seq``
coordinate (the pipe groups are per coordinate of every other axis, as
are the tied copies').  The last stage gathers its output over ``seq``
(:func:`~deepspeed_tpu_torch.comm.gather_seq`, whose backward sends
each chunk its gradient) and hands ``loss_fn`` the whole sequence and
the whole labels, as the JAX pipeline does, with the losses'
normalisers counting over ``data`` alone
(:func:`~deepspeed_tpu_torch.parallel.mesh.whole_sequence`); every seq
rank takes 1/N of that loss, so the ranks' parts summed over ``seq``
are the loss and their gradients the whole one.  The gradient is
summed over ``seq`` by the base engine's exchange, and the step's stats
all-reduce runs over ``pipe`` × ``data`` × ``seq``, the flag and the
norm counted at ``seq`` coordinate 0.  Each chunk draws its dropout
streams from a ``seq`` sub-stream, and the attention cores' in-kernel
dropout its seed words from the stream before it
(``attn_seed_rng``), the same on every seq rank.

ZeRO-3 (JAX: inherited from its ``DeepSpeedEngine``): each stage's
flat master is partitioned over its data group, and the stage's
compute params are gathered before a forward instruction that finds
them freed, and freed once no micro-batch is in flight (a micro-batch
in flight holds them in its graph, so a backward always finds them):
after a backward that leaves none, after the step and after an
evaluation.  The tied copies' gradients are summed
over their stages (``ReduceTiedGrads``) before the reduce-scatter.
1-bit Adam (stage 0): the compressed step exchanges each stage's
momentum over its data group after ``ReduceTiedGrads``, with the
compression's scales over every stage (a tied param counted once), so
the tied copies stay equal; its error buffers are each stage's and
rank's.
ZeRO-Offload: each stage's host master and optimizer state are its
data rank's rows of the stage's layout, updated at ``OptimizerStep`` by
the base engine's offload step over the stage's data group.

Checkpoints are the JAX package's files for the whole tree: each
stage's leaves are joined over ``model``, the stages' rows are gathered
to global rank 0, which writes them, and every rank reads its own
leaves back (its slices of them), so a checkpoint moves between stage
counts, model degrees and the two packages.

Profiling (ROADMAP A23; the ``flops_profiler`` and ``profiling``
blocks): the memory ledger measures each stage's first forward and
backward instruction and its first optimizer apply; the comm ledger
records the first batch's schedule up to ``OptimizerStep`` as
``fwd_bwd`` (the point-to-point transfers, as ``p2p_transfer`` nodes of
its overlap summary, and the tied copies' all-reduce) and the step as
``apply_update``, the JAX pipeline's two programs, so the receipts
(``comm_receipt``, ``overlap_receipt``, ``attribution_receipt``) count
``fwd_bwd`` once a step; the flops profiler counts the ``profile_step``-th
batch's instructions, each stage its own layers; the driver bracket
runs from the batch's start to its step's last launch.
"""

import bisect
import itertools
import logging
import time

import numpy as np
import torch
import torch.distributed as dist

from ... import comm
from ...models.layers import SEQ_STREAM, mix_seed
from ...parallel.mesh import (DATA_AXIS, EXPERT_AXIS, PIPE_AXIS, SEQ_AXIS,
                              Mesh, current_mesh, make_mesh, whole_sequence)
from ...utils.distributed import get_rank, get_world_size, init_distributed
from ...utils.params import tree_leaves
from ..config import get_mesh_config, get_pipeline_config
from ..config_utils import load_config_json
from ..dataloader import RepeatingLoader
from ..engine import SEQ_MODEL_ITEM, DeepSpeedEngine
from ..utils import tree_path_key
from .module import PipelineModule, split_batch, stage_generator
from .schedule import (BackwardPass, DataParallelSchedule, ForwardPass,
                       InferenceSchedule, LoadMicroBatch, OptimizerStep,
                       PipeSchedule, RecvActivation, RecvGrad, ReduceGrads,
                       ReduceTiedGrads, SendActivation, SendGrad,
                       TrainSchedule)

logger = logging.getLogger(__name__)

# the activation metadata ahead of a batch's first transfer across a
# stage boundary: the tensor count, a tuple flag, and per tensor a dtype
# code, the rank and up to _META_DIMS sizes
_META_TENSORS = 8
_META_DIMS = 6
_META_LEN = 2 + _META_TENSORS * (2 + _META_DIMS)
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool)
_COMM = (SendActivation, RecvActivation, SendGrad, RecvGrad)
# MoE under a pipeline: absent from the JAX package, re-filed in ROADMAP
MOE_PIPE_ITEM = "ROADMAP A21"


class InterleavedSchedule(PipeSchedule):
    """The instruction stream of ``interleave`` > 1 virtual stages (and
    of a forward pass at one stage): the JAX program's ticks
    (``engine.py:215-259``), every forward tick, then (``train``) every
    backward tick in reverse.  Rank ``s`` works at tick ``t`` on work
    index ``w = t - s`` (valid in ``[0, interleave × micro_batches)``):
    chunk ``c = (w // stages) % interleave``, micro-batch ``(w //
    (stages × interleave)) × stages + w % stages``, logical stage ``c ×
    stages + s``; its output goes to rank ``s + 1`` (mod stages) for the
    next tick.  The buffer of a work index is the index itself."""

    def __init__(self, micro_batches, stages, stage_id, interleave=1,
                 train=True):
        super().__init__(micro_batches, stages, stage_id)
        self.interleave = interleave
        self.train = train

    @property
    def logical_stages(self):
        return self.stages * self.interleave

    def work(self, tick):
        """``(w, micro_batch, logical stage)`` of this rank at ``tick``,
        or None in the fill or the drain."""
        S, v = self.stages, self.interleave
        w = tick - self.stage_id
        if not 0 <= w < v * self.micro_batches:
            return None
        c = (w // S) % v
        return w, (w // (S * v)) * S + w % S, c * S + self.stage_id

    def num_pipe_buffers(self):
        return self.interleave * self.micro_batches

    def steps(self):
        last = self.logical_stages - 1
        ticks = self.interleave * self.micro_batches + self.stages - 1
        prev = None
        for t in range(ticks):
            cur, cmds = self.work(t), []
            if prev is not None and prev[2] < last:
                cmds.append(SendActivation(prev[0]))
            if cur is not None and cur[2] > 0:
                cmds.append(RecvActivation(cur[0]))
            if cur is not None and cur[2] in (0, last):
                cmds.append(LoadMicroBatch(cur[0]))
            if cur is not None:
                cmds.append(ForwardPass(cur[0]))
            prev = cur
            yield cmds
        if not self.train:
            return
        prev = None
        for t in reversed(range(ticks)):
            cur, cmds = self.work(t), []
            if prev is not None and prev[2] > 0:
                cmds.append(SendGrad(prev[0]))
            if cur is not None and cur[2] < last:
                cmds.append(RecvGrad(cur[0]))
            if cur is not None:
                cmds.append(BackwardPass(cur[0]))
            if t == 0:
                cmds += [ReduceTiedGrads(), ReduceGrads(), OptimizerStep()]
            prev = cur
            yield cmds


class _StageModel:
    """The base engine's model contract for one stage: ``init`` is the
    stage's param tree."""

    def __init__(self, engine):
        self.engine = engine

    def init(self, seed):
        return self.engine._stage_params(seed)

    def partition_specs(self, mesh=None):
        return self.engine.pipe_module.stage_specs(self.engine.stage_layers)

    def apply(self, *args, **kwargs):
        raise RuntimeError("Only train_batch() and eval_batch() are "
                           "accessible in pipeline mode.")


class PipelineEngine(DeepSpeedEngine):
    """Training engine for :class:`PipelineModule` models: one stage of
    the mesh's ``pipe`` axis (of one data-parallel coordinate).
    ``train_batch``/``eval_batch`` are the loop API; ``forward`` and
    ``backward`` raise, as the reference's pipeline engine does.

    ``model_parameters`` may be the whole tree (each stage cuts its own
    leaves from it); without it each stage draws only its own layers
    (:meth:`PipelineModule.init_stage`).  Without a mesh, above one
    process, the mesh is ``{"pipe": num_stages (or pipeline.stages),
    "data": -1}``."""

    def __init__(self, args=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None,
                 lr_scheduler=None, mpu=None, dist_init_required=None,
                 collate_fn=None, config=None, config_params=None,
                 mesh=None, device=None):
        if not isinstance(model, PipelineModule):
            raise TypeError("PipelineEngine requires a PipelineModule")
        config = config if config is not None else config_params
        if config is None and args is not None:
            config = getattr(args, "deepspeed_config", None)
        if config is None:
            raise ValueError("DeepSpeed requires --deepspeed_config, a config "
                             "dict, or config_params")
        param_dict = (config if isinstance(config, dict)
                      else load_config_json(config))
        if dist_init_required or dist_init_required is None:
            init_distributed(device=device)
        if mesh is None and mpu is not None:
            mesh = Mesh.from_mpu(mpu)
        pipe_cfg = get_pipeline_config(param_dict)
        if mesh is None and get_world_size() > 1:
            dims = get_mesh_config(param_dict)
            stages = model.num_stages or pipe_cfg.get("stages")
            if stages and int(dims.get(PIPE_AXIS, 1)) == 1:
                dims[PIPE_AXIS] = int(stages)
            mesh = make_mesh(dims)
        self.pipe_module = model
        self._whole_params = model_parameters
        self._client_optimizer = optimizer
        self._apply_pipeline_config(pipe_cfg)
        if mesh is not None and mesh.size(PIPE_AXIS) > 1:
            self._stats_axes = (PIPE_AXIS, DATA_AXIS)
        super().__init__(model=_StageModel(self), optimizer=optimizer,
                         training_data=training_data,
                         lr_scheduler=lr_scheduler, dist_init_required=False,
                         collate_fn=collate_fn, config=param_dict, mesh=mesh,
                         device=device)
        self.micro_batches = self.gradient_accumulation_steps()
        self._check_boundaries = True
        # the memory ledger's stage entry points (the base engine's wrap
        # its loss and backward, which the schedule does not call)
        self._forward = self.memory_ledger.wrap("forward", self._forward)
        self._backward = self.memory_ledger.wrap("backward", self._backward)
        if self.mesh is not None and self.pipe_world_size > 1:
            # the pipe group's first collective comes before any
            # point-to-point batch, which NCCL needs of a new group
            comm.barrier(PIPE_AXIS, self.mesh)
        logger.info(f"PipelineEngine: stage {self.stage_id} of "
                    f"{self.pipe_world_size}, layers {self.stage_layers}, "
                    f"micro_batches={self.micro_batches} "
                    f"dp={self.dp_world_size}")

    _pipelined = True

    # ------------------------------------------------------------ set-up
    def _apply_pipeline_config(self, pipe_cfg):
        """The ``pipeline`` block fills the knobs the module's constructor
        left at their defaults (JAX ``engine.py:303-330``)."""
        module, log = self.pipe_module, get_rank() == 0
        interval = pipe_cfg.get("activation_checkpoint_interval", 0)
        if interval and not module.activation_checkpoint_interval:
            module.activation_checkpoint_interval = interval
            if log:
                logger.info(f"pipeline config: activation_checkpoint_"
                            f"interval={interval}")
        part = pipe_cfg.get("partition")
        if part is not None and module.partition_method == "parameters":
            # "best" is the config-level alias for parameter-balanced
            module.partition_method = "parameters" if part == "best" \
                else part
            if log:
                logger.info(f"pipeline config: partition={part}")
        il = pipe_cfg.get("interleave")
        if il is not None and module.interleave == 1:
            module.interleave = max(int(il), 1)
            if log:
                logger.info(f"pipeline config: interleave={il} (virtual "
                            f"stages)")
        elif il is not None and int(il) != module.interleave and log:
            logger.info(f"pipeline config: interleave={il} ignored — the "
                        f"PipelineModule was constructed with interleave="
                        f"{module.interleave}, which takes precedence")

    @property
    def pipe_world_size(self):
        return self.mesh.size(PIPE_AXIS) if self.mesh is not None else 1

    def _refuse(self):
        """What the pipeline engine refuses: MoE, which the JAX package
        has no pipeline path for."""
        if self.mesh is not None and self.mesh.size(EXPERT_AXIS) > 1:
            raise NotImplementedError(
                f"MoE under the pipeline engine (an expert axis above 1) "
                f"is not ported: the JAX package has no such path, its "
                f"PipelineModule carries no MoE aux loss across stages "
                f"({MOE_PIPE_ITEM})")

    def _refuse_seq_mesh(self, mesh, model):
        """A stage's layers run on its ``seq`` rank's chunk of the
        sequence: a module with a layer that does not declare
        ``seq_parallel`` (:meth:`PipelineModule.seq_unready`) would run
        it on the chunk alone, and is refused naming
        ``SEQ_MODEL_ITEM``."""
        unready = self.pipe_module.seq_unready()
        if unready:
            raise NotImplementedError(
                f"a seq axis above 1 runs each pipeline layer on its "
                f"rank's chunk of the sequence; layers {unready} do not "
                f"declare seq_parallel = True (per position, or the "
                f"port's attention cores over seq), and a pipeline that "
                f"runs them on the whole sequence is not ported yet "
                f"({SEQ_MODEL_ITEM})")

    def _resolve_comm_overlap(self, zc, client_optimizer):
        """The instruction stream exchanges the gradient at its own
        instructions, so the bucketed exchange (``overlap_comm``), whose
        hooks follow the base engine's backward, stays off; ``true``
        raises."""
        if zc.overlap_comm is True:
            raise ValueError("zero_optimization.overlap_comm: true but the "
                             "bucketed exchange does not run under the "
                             "pipeline engine")
        return False, "the pipeline engine exchanges at ReduceGrads"

    def _stage_params(self, seed):
        """Partition the layers, place this rank's logical stages, set up
        the tied copies' bookkeeping and groups, and return the stage's
        param tree (cut from the whole tree, or drawn alone)."""
        module = self.pipe_module
        S = self.pipe_world_size
        self.stage_id = (self.mesh.index(PIPE_AXIS) if self.mesh is not None
                         else 0)
        self._refuse()
        if module.num_stages is not None and module.num_stages != S:
            raise ValueError(f"PipelineModule(num_stages={module.num_stages})"
                             f" but the mesh's pipe axis is {S}")
        if module.loss_fn is None:
            raise ValueError("PipelineModule requires loss_fn to train under "
                             "the engine")
        v = module.interleave if S > 1 else 1
        L = S * v
        if v > 1:
            M = self.gradient_accumulation_steps()
            # AssertionError, as the JAX engine's asserts raise it
            if M % S:
                raise AssertionError(
                    f"interleave={v} needs micro_batches ({M}) divisible by "
                    f"stages ({S}) — the schedule works in groups of one "
                    f"micro-batch per rank")
            if module.num_layers < L:
                raise AssertionError(
                    f"interleave={v} with {S} stages needs >= {L} layers "
                    f"(got {module.num_layers}) — empty logical stages "
                    f"would silently forfeit the bubble reduction")
        self.interleave = v
        whole = self._whole_params
        if S == 1:
            parts = [0, module.num_layers]
        else:
            counts = None
            if module.partition_method.lower() == "parameters":
                counts = module.layer_param_counts(whole, seed)
            parts = module.partition_layers(L, param_counts=counts)
        self.parts = parts
        self._logical = [l for l in range(L) if l % S == self.stage_id]
        self.stage_layers = [i for l in self._logical
                             for i in range(parts[l], parts[l + 1])]
        holders = {}
        for i in range(module.num_layers):
            key = module.tied_key_of(i)
            if key is not None:
                holders.setdefault(key, set()).add(self._rank_of_layer(i))
        self._tied_owner = {k: self._rank_of_layer(i)
                            for k, i in module.tied_keys.items()}
        self._cross_tied = [k for k in sorted(holders)
                            if len(holders[k]) > 1
                            and self.stage_id in holders[k]]
        self._tied_groups = self._build_tied_groups(holders)
        params = (module.select_stage(whole, self.stage_layers)
                  if whole is not None
                  else module.init_stage(seed, self.stage_layers))
        self._whole_params = None
        return params

    def _rank_of_layer(self, idx):
        return (bisect.bisect_right(self.parts, idx) - 1) % \
            self.pipe_world_size

    def _build_tied_groups(self, holders):
        """One process group per tied key held by several stages and per
        data coordinate (every rank creates every group, in one order);
        this rank's, by key."""
        groups = {}
        if not dist.is_initialized() or self.pipe_world_size == 1:
            return groups
        topo, world = self.mesh.topology, get_world_size()
        others = [ax for ax in topo.axes if ax != PIPE_AXIS]
        for key in sorted(holders):
            if len(holders[key]) < 2:
                continue
            # one group per coordinate of every other axis (data, model)
            for rest in itertools.product(*(range(self.mesh.size(ax))
                                            for ax in others)):
                ranks = []
                for s in sorted(holders[key]):
                    coord = dict(zip(others, rest))
                    coord[PIPE_AXIS] = s
                    ranks.append(topo.get_rank(**coord))
                group = (dist.group.WORLD if len(ranks) == world
                         else dist.new_group(ranks))
                if get_rank() in ranks:
                    groups[key] = group
        return groups

    def _defer_exchange(self):
        return bool(self._cross_tied)

    def _release_compute(self):
        """ZeRO-3: the stage's compute params are freed once no
        micro-batch is in flight (after a backward that leaves none, and
        after the step); a micro-batch in flight holds them in its graph,
        and gathering them again would write under it."""
        if getattr(self, "_live", None):
            return
        super()._release_compute()

    def _compressed_loss(self):
        """1-bit Adam's compressed step: the last stage's mean loss on
        every stage (a sum over ``pipe``, and the chunks' parts over
        ``seq``), averaged over ``data``."""
        if self.pipe_world_size == 1:
            return super()._compressed_loss()
        loss = (torch.stack(self._losses).float().mean() if self._losses
                else torch.zeros((), dtype=torch.float32,
                                 device=self.device))
        loss = comm.psum(loss, self._loss_axes(), self.mesh)
        return comm.pmean(loss, DATA_AXIS, self.mesh)

    def _loss_axes(self):
        """The axes the last stage's loss is summed over to every rank:
        ``pipe``, and ``seq`` above one rank (its chunks' parts)."""
        return (PIPE_AXIS, SEQ_AXIS) if self.sp_world_size > 1 \
            else PIPE_AXIS

    def _onebit_scale_axes(self):
        axes = super()._onebit_scale_axes() or ()
        if self.pipe_world_size > 1:
            axes = (PIPE_AXIS, *axes)
        return axes or None

    def _onebit_row_weights(self):
        """The base weights, with the rows of a tied copy whose owning
        layer is on another stage at 0: a tied param counts once."""
        w = super()._onebit_row_weights().clone()
        for key in self._cross_tied:
            if self._tied_owner[key] != self.stage_id:
                r0, r1 = self._tied_rows()[key]
                w[r0:r1] = 0.0
        return w

    def _is_writer(self):
        return (self.dp_rank == 0 and self.stage_id == 0
                and self._tp_coords == (0, 0))

    # ------------------------------------------------------ loop API
    def is_gradient_accumulation_boundary(self):
        # one train_batch covers every micro-batch
        return True

    def forward(self, *args, **kwargs):
        raise RuntimeError("Only train_batch() is accessible in pipeline "
                           "mode.")

    __call__ = forward

    def backward(self, *args, **kwargs):
        raise RuntimeError("Only train_batch() is accessible in pipeline "
                           "mode.")

    def _schedule(self, kind, micro_batches, stage_id):
        S, v = self.pipe_world_size, self.interleave
        if kind == "train":
            if S == 1:
                return DataParallelSchedule(micro_batches, 1, 0)
            if v == 1:
                return TrainSchedule(micro_batches, S, stage_id)
            return InterleavedSchedule(micro_batches, S, stage_id, v)
        if S > 1 and v == 1:
            return InferenceSchedule(micro_batches, S, stage_id)
        return InterleavedSchedule(micro_batches, S, stage_id, v,
                                   train=False)

    def schedule_trace(self, stage_id=0, kind="train", micro_batches=None):
        """The instruction stream that ``train_batch`` (``kind="train"``)
        or ``eval_batch`` runs on ``stage_id``, one list a step: the JAX
        package's ``TrainSchedule``/``InferenceSchedule`` streams above
        one stage at ``interleave`` 1, the interleaved ticks above it,
        ``DataParallelSchedule`` at one stage."""
        sched = self._schedule(kind, micro_batches or self.micro_batches,
                               stage_id)
        return [list(step) for step in sched]

    def train_batch(self, data_iter=None):
        """One optimizer step over ``gradient_accumulation_steps``
        micro-batches drawn from ``data_iter`` (default: the training
        dataloader, repeated) on the first and last stages.  Returns the
        step's mean loss as a device tensor, on every rank."""
        if data_iter is None:
            if self.training_dataloader is None:
                raise ValueError("train_batch() without an iterator needs "
                                 "initialize(training_data=...)")
            if self._train_iter is None:
                self._train_iter = iter(RepeatingLoader(
                    self.training_dataloader))
            data_iter = self._train_iter
        self.tput_timer.start()
        t_host0 = time.perf_counter()
        self._fetch_secs = 0.0
        self._losses = []
        self._batch_seed = mix_seed(self._config.seed, self.micro_steps)
        if self._flops_armed() and not self.flops_profiler.active:
            self.flops_profiler.begin_step()
        # the whole batch up to OptimizerStep is one fwd_bwd phase
        self.comm_ledger.begin("fwd_bwd")
        try:
            self._run(self._schedule("train", self.micro_batches,
                                     self.stage_id), data_iter, train=True)
        finally:
            self._end_fwd_bwd()
        self._driver_latencies.record(
            time.perf_counter() - t_host0 - self._fetch_secs)
        self.tput_timer.stop()
        if self.telemetry.enabled:
            # the train engine's per-step telemetry (JAX
            # ``pipe/engine.py:389-399``): host bookkeeping only
            self.telemetry.counter("train/steps").inc()
            self.telemetry.counter("train/samples").inc(
                self.train_batch_size())
            self.telemetry.histogram("train/host_step_secs").observe(
                time.perf_counter() - t_host0)
            self.telemetry.poll_device_trace(self.global_steps)
        return self._step_loss

    def eval_batch(self, data_iter):
        """The mean loss with ``train=False`` over ``micro_batches``
        micro-batches of an iterator, or over one batch, on every rank
        (averaged over the data-parallel ranks)."""
        if hasattr(data_iter, "__next__"):
            micro_batches, it = self.micro_batches, data_iter
        else:
            micro_batches, it = 1, iter([data_iter])
        self._eval_losses = []
        with torch.no_grad():
            self._run(self._schedule("eval", micro_batches, self.stage_id),
                      it, train=False)
            zero = torch.zeros((), dtype=torch.float32, device=self.device)
            loss = (torch.stack(self._eval_losses).float().mean()
                    if self._eval_losses else zero)
            if self.mesh is not None and self.pipe_world_size > 1:
                loss = comm.psum(loss, self._loss_axes(), self.mesh)
            elif self.mesh is not None and self.sp_world_size > 1:
                loss = comm.psum(loss, SEQ_AXIS, self.mesh)
            if self.mesh is not None and self.dp_world_size > 1:
                loss = comm.pmean(loss, DATA_AXIS, self.mesh)
        if self._stage3:
            self._release_compute()
        return loss

    # ------------------------------------------------------- interpreter
    def _run(self, sched, data_iter, train):
        """Execute ``sched`` in order (a step's consecutive transfers as
        one batch), logging each instruction as it runs
        (``executed``)."""
        self._data_iter = data_iter
        self._train = train
        self._sched = sched
        self._specs_out = {}   # logical stage -> the boundary it sent
        self._specs_in = {}    # logical stage -> the boundary it received
        self._live = {}        # buffer id -> the micro-batch in flight
        self._grads_in = {}    # buffer id -> gradients to send back
        self._fwd_count = 0
        self.max_live_buffers = 0
        self.executed = []
        with current_mesh(self.mesh):
            for step in sched:
                self.executed.append([])
                for transfers, cmds in itertools.groupby(
                        step, key=lambda c: isinstance(c, _COMM)):
                    cmds = list(cmds)
                    if transfers:
                        self._exec_comm(cmds)
                        continue
                    for cmd in cmds:
                        self._exec(cmd)
                        self.executed[-1].append(cmd)

    def _exec(self, cmd):
        if isinstance(cmd, LoadMicroBatch):
            self._load(cmd.buffer_id)
        elif isinstance(cmd, ForwardPass):
            self._forward(cmd.buffer_id)
        elif isinstance(cmd, BackwardPass):
            self._backward(cmd.buffer_id)
        elif isinstance(cmd, ReduceTiedGrads):
            self._reduce_tied_grads()
        elif isinstance(cmd, ReduceGrads):
            pass  # the data-parallel exchange opens the step below
        elif isinstance(cmd, OptimizerStep):
            self._end_fwd_bwd()
            M = self.micro_batches
            self.micro_steps += M
            self.global_samples += (self.train_micro_batch_size_per_gpu()
                                    * self.dp_world_size * M)
            self.step()
        else:
            raise NotImplementedError(f"unknown instruction {cmd!r}")

    def _end_fwd_bwd(self):
        """The batch's forward-backward ends: the comm ledger's pricer
        (entered last) closes, then the flops profiler's count of it."""
        self.comm_ledger.end("fwd_bwd")
        if self.flops_profiler is not None and self.flops_profiler.active:
            self.flops_profiler.end_micro_batch()

    def _fwd_bwd_multiplicity(self):
        # the recorded fwd_bwd is the whole batch: once a step
        return 1

    def _work(self, b, entry):
        """``(micro-batch, logical stage)`` of buffer ``b``: from the
        work index in the interleaved stream, else the forward count."""
        if "micro" not in entry:
            if isinstance(self._sched, InterleavedSchedule):
                S, v = self.pipe_world_size, self.interleave
                entry["micro"] = (b // (S * v)) * S + b % S
            else:
                entry["micro"] = self._fwd_count
            entry["logical"] = self._logical_of(b)
        return entry["micro"], entry["logical"]

    def _logical_of(self, b):
        """The logical stage that works on buffer ``b`` on this rank."""
        if isinstance(self._sched, InterleavedSchedule):
            S, v = self.pipe_world_size, self.interleave
            return ((b // S) % v) * S + self.stage_id
        return self.stage_id

    def _entry(self, b):
        """Buffer ``b``'s micro-batch, opened on its first fill; a fill
        of a buffer whose micro-batch has run its forward is a schedule
        fault."""
        entry = self._live.get(b)
        if entry is None:
            entry = self._live[b] = {}
            self.max_live_buffers = max(self.max_live_buffers,
                                        len(self._live))
        elif "y" in entry or "loss" in entry:
            raise RuntimeError(f"pipe buffer {b} refilled while its "
                               f"micro-batch is in flight")
        return entry

    def _load(self, b):
        inputs, labels = split_batch(next(self._data_iter))
        entry = self._entry(b)
        _, logical = self._work(b, entry)
        if logical == 0:
            entry["x"] = self._seq_chunk(self._to_device(inputs))
        if logical == self.pipe_world_size * self.interleave - 1:
            entry["labels"] = self._to_device(labels)

    def _seq_chunk(self, x):
        """This ``seq`` rank's chunk (dim 1) of every tensor of ``x``;
        ``x`` itself at one rank."""
        n = self.sp_world_size
        if n == 1:
            return x
        if isinstance(x, (tuple, list)):
            return type(x)(self._seq_chunk(t) for t in x)
        if isinstance(x, dict):
            return {k: self._seq_chunk(t) for k, t in x.items()}
        sl = x.shape[1] // n
        if x.shape[1] % n:
            raise ValueError(f"a sequence of {x.shape[1]} positions does "
                             f"not split over {n} seq ranks")
        return x[:, self.sp_rank * sl:(self.sp_rank + 1) * sl]

    def _stream_seed(self, micro, logical, seq=True):
        """The stage's dropout stream for ``micro`` (with ``seq``, this
        seq rank's sub-stream of it)."""
        seed = mix_seed(self._batch_seed, micro)
        if self.pipe_world_size > 1:
            seed = mix_seed(seed, logical)
        if self.dp_rank:
            seed = mix_seed(seed, self.dp_rank)
        if seq and self.sp_rank:
            seed = mix_seed(seed, SEQ_STREAM + self.sp_rank)
        return seed

    def _whole_output(self, y):
        """The last stage's output ``y`` (a tensor or a tuple, list or
        dict of them) gathered over ``seq`` along dim 1; ``y`` itself at
        one rank."""
        if isinstance(y, (tuple, list)):
            return type(y)(self._whole_output(t) for t in y)
        if isinstance(y, dict):
            return {k: self._whole_output(t) for k, t in y.items()}
        if not torch.is_tensor(y) or y.dim() < 2:
            return y
        return comm.gather_seq(y, dim=1, mesh=self.mesh)

    def _forward(self, b):
        entry = self._live[b]
        micro, logical = self._work(b, entry)
        self._fwd_count += 1
        if self._stage3:
            self._gather_compute()
        lo, hi = self.parts[logical], self.parts[logical + 1]
        kw = {"deterministic": not self._train}
        if self._train:
            kw["rng"] = stage_generator(self._stream_seed(micro, logical),
                                        entry["x"])
            if self.sp_world_size > 1:
                kw["attn_seed_rng"] = stage_generator(
                    self._stream_seed(micro, logical, seq=False), entry["x"])
        y = self.pipe_module.apply_range(self.params, lo, hi, entry["x"],
                                         **kw)
        if logical == self.pipe_world_size * self.interleave - 1:
            if self.sp_world_size > 1:
                # the whole sequence's loss on every seq rank, each rank
                # its 1/N part of it
                with whole_sequence():
                    loss = self.pipe_module.loss_fn(self._whole_output(y),
                                                    entry["labels"])
                loss = loss / self.sp_world_size
            else:
                loss = self.pipe_module.loss_fn(y, entry["labels"])
            if self._train:
                entry["loss"] = loss
                self._losses.append(loss.detach())
            else:
                self._eval_losses.append(loss.detach())
                del self._live[b]
        else:
            entry["y"] = y
            if not self._train:
                entry.pop("x")

    def _backward(self, b):
        entry = self._live.pop(b)
        if "loss" in entry:
            self._scaled_loss(entry["loss"]).backward()
        else:
            pairs = [(t, g) for t, g in zip(_floating(entry["y"]),
                                            entry["grad_out"])
                     if t.requires_grad]
            if pairs:
                torch.autograd.backward([t for t, _ in pairs],
                                        [g for _, g in pairs])
        if entry["logical"] > 0:
            self._grads_in[b] = [
                t.grad if t.grad is not None else torch.zeros_like(t)
                for t in _floating(entry["x"])]
        self._after_backward()

    # ------------------------------------------------------ p2p
    def _neighbours(self):
        S = self.pipe_world_size
        return (self.stage_id + 1) % S, (self.stage_id - 1) % S

    def _exec_comm(self, cmds):
        """A step's consecutive transfers as one batch, after the
        metadata of the batch's first activation across each stage
        boundary (the k-th send of a link meets its k-th receive, so the
        first of a boundary meets the first)."""
        nxt, prv = self._neighbours()
        meta_sends, meta_recvs = [], []
        for c in cmds:
            if isinstance(c, SendActivation):
                entry = self._live[c.buffer_id]
                spec = _spec(entry["y"])
                self._check_uniform(entry, spec)
                sent = self._specs_out.get(entry["logical"])
                if sent is None:
                    self._specs_out[entry["logical"]] = spec
                    meta_sends.append((_encode_meta(entry["y"], self.device),
                                       nxt))
                elif sent != spec:
                    raise ValueError(
                        f"the micro-batches of one batch must cross a stage "
                        f"boundary with one activation structure: logical "
                        f"stage {entry['logical']} sent {sent} first, now "
                        f"{spec}")
            elif isinstance(c, RecvActivation):
                logical = self._logical_of(c.buffer_id)
                if logical not in self._specs_in and logical not in [
                        l for l, _ in meta_recvs]:
                    meta_recvs.append((logical, torch.empty(
                        _META_LEN, dtype=torch.int64, device=self.device)))
        if meta_sends or meta_recvs:
            comm.send_recv(meta_sends, [(m, prv) for _, m in meta_recvs],
                           PIPE_AXIS, self.mesh)
            for logical, meta in meta_recvs:
                self._specs_in[logical] = _decode_meta(meta)
        sends, recvs, landed = [], [], []
        for c in cmds:
            b = c.buffer_id
            if isinstance(c, SendActivation):
                sends += [(_wire(t), nxt) for t in _tensors(self._live[b]["y"])]
            elif isinstance(c, SendGrad):
                sends += [(_wire(g), prv) for g in self._grads_in[b]]
            elif isinstance(c, RecvActivation):
                spec = self._specs_in[self._logical_of(b)]
                bufs = [torch.empty(shape, dtype=dtype, device=self.device)
                        for dtype, shape in spec[1]]
                recvs += [(_wire(t), prv) for t in bufs]
                landed.append((c, bufs, spec))
            elif isinstance(c, RecvGrad):
                bufs = [torch.empty_like(t)
                        for t in _floating(self._live[b]["y"])]
                recvs += [(_wire(t), nxt) for t in bufs]
                landed.append((c, bufs, None))
        comm.send_recv(sends, recvs, PIPE_AXIS, self.mesh)
        for c, bufs, spec in landed:
            if isinstance(c, RecvActivation):
                entry = self._entry(c.buffer_id)
                if self._train:
                    for t in bufs:
                        if t.is_floating_point():
                            t.requires_grad_(True)
                entry["x"] = tuple(bufs) if spec[0] else bufs[0]
                entry["meta_in"] = spec
            else:
                self._live[c.buffer_id]["grad_out"] = bufs
        for c in cmds:
            if isinstance(c, SendGrad):
                del self._grads_in[c.buffer_id]
            elif isinstance(c, SendActivation) and not self._train:
                del self._live[c.buffer_id]
        self.executed[-1].extend(cmds)

    def _check_uniform(self, entry, spec):
        """A stage boundary must equal the one before it (JAX
        ``engine.py:132-150``): noted here, raised on every rank at the
        first step (:meth:`_step_stats`)."""
        spec_in = entry.get("meta_in")
        if spec_in is not None and spec_in != spec:
            self._boundary_mismatch = True

    # ------------------------------------------------------ the step
    def _reduce_tied_grads(self):
        """Each tied copy's gradient summed over the stages that hold one
        (the full flat gradient, before the data-parallel exchange)."""
        if not self._cross_tied:
            return
        buf = self._acc if self._acc is not None else self._grad
        for key in self._cross_tied:
            r0, r1 = self._tied_rows()[key]
            comm.psum_group(buf[r0:r1], self._tied_groups[key])

    def _tied_rows(self):
        """``{tied key: (first row, end row)}`` of its leaves in the
        stage's flat layout (contiguous: they sort together)."""
        if not hasattr(self, "_tied_row_cache"):
            rows = {}
            seg = self.segments
            for i, path in enumerate(self.flat.paths):
                if path[0] != "tied":
                    continue
                r0 = seg.row_offsets[i]
                r1 = r0 + seg.row_counts[i]
                lo, hi = rows.get(path[1], (r0, r1))
                rows[path[1]] = (min(lo, r0), max(hi, r1))
            self._tied_row_cache = rows
        return self._tied_row_cache

    def _norm_sq(self, g):
        """This rank's share of the global norm's square: its rows of the
        gradient without the tied copies whose owning layer is on
        another stage (a tied param counts once), and only on data rank
        0 where every data rank holds the whole stage."""
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        if not self._partitioned and self.dp_rank:
            return zero
        skip = [self._tied_rows()[k] for k in self._cross_tied
                if self._tied_owner[k] != self.stage_id]
        lo = self.flat.row0
        hi = lo + g.shape[0]
        cuts, total = [lo], zero
        for r0, r1 in sorted(skip):
            cuts += [max(lo, min(hi, r0)), max(lo, min(hi, r1))]
        cuts.append(hi)
        for a, b in zip(cuts[::2], cuts[1::2]):
            if b > a and self._tp:
                # a leaf replicated over model counts at coordinate 0
                total = total + self._tp_norm_sq(g[a - lo:b - lo],
                                                 slice(a - lo, b - lo))
            elif b > a:
                total = total + torch.linalg.vector_norm(
                    g[a - lo:b - lo], dtype=torch.float32).square()
        return total

    def _step_stats(self, flag, g, clip):
        """Above one stage: the flag, the last stage's mean loss and the
        norm's square summed over the ``pipe`` and ``data`` axes in one
        all-reduce, with the boundary check of the first step."""
        if self.pipe_world_size == 1:
            return super()._step_stats(flag, g, clip)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        last = (self.stage_id == self.pipe_world_size - 1
                and self._tp_coords == (0, 0))
        loss = torch.stack(self._losses).float().mean() if last else zero
        sq = self._norm_sq(g) if clip > 0.0 else zero
        bad = zero + float(getattr(self, "_boundary_mismatch", False))
        # the gradient is the seq ranks' sum already: the flag and the
        # norm count at seq coordinate 0, the loss sums the chunks' parts
        seq0 = float(self.sp_rank == 0)
        stats = comm.psum(torch.stack([flag * seq0, loss, sq * seq0, bad]),
                          self._stats_axes, self.mesh)
        if self._check_boundaries:
            self._check_boundaries = False
            if float(stats[3]) > 0:
                raise AssertionError(
                    "pipeline stages must exchange one uniform activation "
                    "structure: a stage boundary's tensors differ from the "
                    "one before it")
        return (stats[0], stats[1] / self.dp_world_size,
                stats[2].sqrt() if clip > 0.0 else None)

    # ------------------------------------------------------ checkpoints
    def _global_leaves(self):
        """``(order, by_stage)``: every leaf of the whole tree as ``(path,
        size)`` in the JAX package's order (a tied leaf once), and each
        stage's leaves in its own flat order (gathered once over the pipe
        group)."""
        if not hasattr(self, "_leaf_cache"):
            mine = list(zip(self.flat.paths,
                            [int(np.prod(sh)) for sh in self._whole_shapes],
                            self._whole_shapes))
            gathered = [None] * self.pipe_world_size
            dist.all_gather_object(gathered, mine,
                                   group=self.mesh.group(PIPE_AXIS))
            self._leaf_shapes = {p: shape for leaves in gathered
                                 for p, _, shape in leaves}
            by_stage = [[(p, n) for p, n, _ in leaves]
                        for leaves in gathered]
            sizes = {p: n for leaves in by_stage for p, n in leaves}
            self._leaf_cache = ([(p, sizes[p]) for p in sorted(sizes)],
                                by_stage)
        return self._leaf_cache

    def _param_count(self):
        if self.pipe_world_size == 1:
            return super()._param_count()
        return int(sum(n for _, n in self._global_leaves()[0]))

    def _gather_stages(self, local, dtype):
        """The stages' 1-D leaf concatenations (``local``, this stage's,
        a tensor) onto global rank 0 as ``{path: 1-D tensor}`` on the
        host, a tied leaf from its owner (None elsewhere).  Data rank 0
        of each stage takes part."""
        order, by_stage = self._global_leaves()
        if self.dp_rank or self._tp_coords != (0, 0):
            return None
        if self.stage_id:
            comm.send_recv(sends=[(_wire(local.to(self.device)), 0)],
                           axis_name=PIPE_AXIS, mesh=self.mesh)
            return None
        bufs = {s: torch.empty(sum(n for _, n in by_stage[s]), dtype=dtype,
                               device=self.device)
                for s in range(1, self.pipe_world_size)}
        comm.send_recv(recvs=[(_wire(buf), s) for s, buf in bufs.items()],
                       axis_name=PIPE_AXIS, mesh=self.mesh)
        bufs[0] = local
        leaves = {}
        for s in range(self.pipe_world_size):
            flat = bufs[s].to("cpu", copy=True)
            off = 0
            for path, n in by_stage[s]:
                owner = (path[0] != "tied"
                         or self._tied_owner[path[1]] == s)
                if owner or path not in leaves:
                    leaves[path] = flat[off:off + n]
                off += n
        return leaves

    def _gather_unpadded(self, buf):
        # the stage's whole leaves (joined over model)
        local = super()._gather_unpadded(buf)
        if self.pipe_world_size == 1:
            return local
        leaves = self._gather_stages(torch.from_numpy(local), torch.float32)
        if leaves is None:
            return None
        order, _ = self._global_leaves()
        return torch.cat([leaves[p] for p, _ in order]).numpy()

    def _params_to_host(self):
        if self.pipe_world_size == 1:
            return super()._params_to_host()
        if self._stage3:
            # no persistent compute params: the master's cast
            with torch.no_grad():
                flat = self.flat.canonical_master(self.master).to(
                    self.compute_dtype)
        else:
            flat = self._compute
        _, parts = tree_leaves(self.flat.unflatten_params(flat))
        local = torch.cat([p.detach().reshape(-1) for p in parts])
        if self._tp:
            local = self._tp_gather_flat(local)
        leaves = self._gather_stages(local, self.compute_dtype)
        if leaves is None:
            return {}
        return {tree_path_key(path): leaves[path].view(
                    self._leaf_shapes[path])
                for path, _ in self._global_leaves()[0]}

    def _scatter_unpadded(self, unpadded, out):
        if self.pipe_world_size == 1:
            return super()._scatter_unpadded(unpadded, out)
        order, _ = self._global_leaves()
        unpadded = np.asarray(unpadded, np.float32).reshape(-1)
        total = sum(n for _, n in order)
        if unpadded.size != total:
            raise ValueError(f"the checkpoint holds {unpadded.size} values "
                             f"but the pipeline's model has {total} "
                             f"parameters")
        offsets, off = {}, 0
        for path, n in order:
            offsets[path] = off
            off += n
        sizes = [int(np.prod(sh)) for sh in self._whole_shapes]
        local = np.concatenate(
            [unpadded[offsets[p]:offsets[p] + n]
             for p, n in zip(self.flat.paths, sizes)]
            or [np.zeros(0, np.float32)])
        # this stage's whole leaves, cut to the rank's slices under model
        return super()._scatter_unpadded(local, out)


def _tensors(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _floating(x):
    return [t for t in _tensors(x) if t.is_floating_point()]


def _wire(t):
    """A tensor as the bytes that cross the wire (a view: a receive
    fills the tensor in place); every backend moves uint8."""
    return t.detach().contiguous().view(-1).view(torch.uint8)


def _spec(x):
    """``(is_tuple, [(dtype, shape), ...])`` of an activation."""
    return (isinstance(x, (tuple, list)),
            [(t.dtype, tuple(t.shape)) for t in _tensors(x)])


def _encode_meta(x, device):
    tensors = _tensors(x)
    if len(tensors) > _META_TENSORS or not all(
            isinstance(t, torch.Tensor) for t in tensors):
        raise ValueError(f"a stage boundary is a tensor or a tuple of at "
                         f"most {_META_TENSORS} tensors, got {type(x)}")
    meta = [len(tensors), int(isinstance(x, (tuple, list)))]
    for t in tensors:
        if t.dim() > _META_DIMS:
            raise ValueError(f"a boundary tensor has at most {_META_DIMS} "
                             f"dims, got {tuple(t.shape)}")
        meta += [_DTYPES.index(t.dtype), t.dim(), *t.shape,
                 *[0] * (_META_DIMS - t.dim())]
    meta += [0] * (_META_LEN - len(meta))
    return torch.tensor(meta, dtype=torch.int64, device=device)


def _decode_meta(meta):
    """``(is_tuple, [(dtype, shape), ...])`` of a metadata tensor."""
    m = meta.tolist()
    specs, at = [], 2
    for _ in range(m[0]):
        dtype, ndim = _DTYPES[m[at]], m[at + 1]
        specs.append((dtype, tuple(m[at + 2:at + 2 + ndim])))
        at += 2 + _META_DIMS
    return bool(m[1]), specs
