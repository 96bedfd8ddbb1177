"""The training engine, the subset on the slice's path (port of
``deepspeed_tpu/runtime/engine.py``: ``initialize`` ``:122-185``,
``forward``/``backward``/``step`` ``:3588-3748``, ``train_batch`` and
``eval_batch`` ``:3808-4071``, ``save_checkpoint`` / ``load_checkpoint``
``:4093-4420``).

State and dtype flow follow the JAX engine:

- the master is one flat fp32 ``(rows, 1024)`` buffer in the row-aligned
  layout (:class:`~deepspeed_tpu_torch.runtime.zero.coordinator.FlatParamCoordinator`);
  the optimizer state is two more buffers of that shape;
- the compute params are one flat buffer in the compute dtype (bf16 under
  ``bf16.enabled``, fp16 under ``fp16.enabled``, else fp32), cast from
  the master after every step;
  the param dict the model sees is views of it, each a leaf of autograd;
- gradients are taken with respect to those compute params, and every
  leaf's ``.grad`` is preset to a view of one flat gradient buffer, so
  autograd accumulates straight into the flat layout: no flatten, no
  per-leaf grads.  That buffer stays in the compute dtype when nothing
  sums into it across micro-batches (one data-parallel rank, no
  accumulation, the JAX engine's rule at ``:1899-1913``); with
  accumulation a fp32 buffer sums the micro-batches;
- clipping by global norm (``:3186-3189``), then the optimizer in fp32
  on the master, in place.

fp16 (``:245-256``, ``:1896-1913``, ``:3176-3257``): ``backward`` scales
the fp32 loss by the current loss scale; ``step`` checks the flat
gradient for a non-finite value, skips the update on one (master and
moments untouched, the LR schedule not stepped, ``skipped_steps`` + 1),
else unscales, clips and updates; a dynamic scale then moves by
:func:`~deepspeed_tpu_torch.runtime.fp16.loss_scaler.update_scale_state`
(halved on overflow after the hysteresis, doubled after
``loss_scale_window`` good steps).  The unscale multiplies in the
gradient's dtype, as the JAX engine does, wherever 1/scale is exact in
it; above a scale of 2^24 it is not in fp16 (the JAX engine's fp16
1/scale rounds to 0 there, so a finite step applies a zero gradient:
ROADMAP C), and the port multiplies in fp32.

Resilience (``resilience`` block, ``:805-840``, ``:3750-3805``): the same
non-finite skip in every precision, the anomaly guard on each step's
loss, overflow and scale, with a rollback to the latest committed
checkpoint or an abort (:mod:`deepspeed_tpu_torch.resilience`), the step
watchdog, and ``initialize(auto_resume=True)``.

Host syncs.  With fp16 and resilience off a step reads nothing back from
the card: the loss comes back as a device tensor, the LR and step count
are host numbers, and the only host sync is the loss fetch at the
``steps_per_print`` cadence (``:3705-3718``).  With either on, each step
makes ONE batched device-to-host copy before its update, as the JAX
engine does (``:3670-3690``): the overflow flag and the mean loss.

Activation checkpointing and Progressive Layer Drop (``:262-274``,
``:668-672``): an ``activation_checkpointing`` block configures
:mod:`~deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing`
and turns on the model's ``remat``; a ``progressive_layer_drop`` block
makes the engine hand the keep probability θ to the model's ``apply``
as ``pld_theta``, a 0-d tensor copied to the device without a sync, and
move θ along its schedule after every step.

ZeRO-Offload (``zero_optimization.cpu_offload``, JAX ``:480-660``,
``:1951-2150``, ``:2310-2545``): the master and the optimizer state live
in pinned host memory in their storage dtypes (fp32, or bf16/fp16 under
``offload_state_dtype``, :mod:`~deepspeed_tpu_torch.runtime.zero.qstate`),
zero-initialized there; the card holds the compute params, the
gradient and the few chunks in flight.  ``step`` clips on the card and
then takes one of three updates: Adam streams the state through the
card chunk by chunk and writes each chunk's compute params from its
updated master rows (:mod:`~deepspeed_tpu_torch.runtime.zero.stream`);
other optimizers (Lamb's per-tensor norms cannot be chunked) take the
one-shot update, the whole state through the card at once;
``DeepSpeedCPUAdam`` updates the host buffers in place in its C++
kernel and sends the params back.  There is no device master to cast
from, so a skipped step moves no state and streams the host master up
once, to re-cast the compute params as the engine without offload
does (a compute param written from outside is healed).
``offload_gradients`` spills the step's gradient as fp32
into a pinned host buffer, which the stream reads back chunk by chunk
with the state (``train_batch`` only, the flat Adam only, no
accumulation: the JAX package's refusals).

Checkpoints are the JAX package's files
(:mod:`deepspeed_tpu_torch.checkpoint`): ``save_checkpoint`` gathers the
state to the host once and commits it on a background writer thread
(``checkpoint.async_save``, the default); ``load_checkpoint`` reads a
checkpoint that either package wrote, at any ZeRO stage 0–2 and any
data-parallel degree, and resumes the step counters (so the dropout
streams), the LR schedule and the dataloader's cursor.

Data parallelism (``initialize(mesh=make_mesh({"data": n}))``, an
``mpu``, or a ``mesh`` config block; JAX ``:195-230``, ``:1896-1913``,
``:2947-2985``): one process per rank over ``torch.distributed`` (NCCL
on the card, gloo on the CPU), each on its slice of the global batch
with its own dropout streams.  The loss is each rank's mean over its
slice, and the gradient the mean over the ranks, summed in fp32 above
one rank or under accumulation (the JAX rule: the flat gradient keeps
the compute dtype only where nothing sums into it).  Stage 0
all-reduces the flat gradient at the accumulation boundary and updates
the whole master on every rank.
Stages 1 and 2 reduce-scatter it onto the rank that owns its rows (stage
1 at the boundary, stage 2 after every micro-batch, accumulating only
the rank's rows), update the rank's rows of the master and the optimizer
state, and rebuild the compute params with one all-gather in the compute
dtype.  The step's one host sync becomes global: the overflow flag, the
loss and the gradient's sum of squares go through ONE all-reduce first,
so every rank clips by the global norm and takes the same skip, scale
and guard decision.  Under ``sparse_gradients`` (stage 0) a model's
declared embedding leaves go through the row-sparse exchange
(:mod:`~deepspeed_tpu_torch.runtime.csr_tensor`).  Checkpoints gather the
master and the moments unpadded; rank 0 writes them, and the ``latest``
pointer and retention with them; a load re-pads onto every rank's rows.

Not in this slice (each refused where asked for, with its ROADMAP item):
ZeRO-3 and ``overlap_comm`` buckets (A8), offload above one rank (A9),
1-bit Adam (A14), telemetry (A12), tensor, sequence and expert
parallelism (A10), pipeline (A13), and resilience's fleet integrity
plane and elastic supervisor (A15's second half).
"""

import dataclasses
import json
import logging
import os
import pickle
import time

import numpy as np
import torch

from .. import comm
from ..checkpoint import writer as ckpt
from ..checkpoint.constants import (CLIENT_STATE_PKL, LATEST_FILE,
                                    META_JSON, OPTIM_STATES_NPZ)
from ..checkpoint.manager import CheckpointManager, drain_inflight
from ..checkpoint.snapshot import capture_engine_snapshot, state_fields
from ..checkpoint.writer import CheckpointCorruptionError, CheckpointError
from ..models.layers import mix_seed
from ..ops.adam import cpu_adam
from ..ops.adam.fused_adam import FusedAdam
from ..ops.lamb.fused_lamb import FusedLamb
from ..ops.op_common import LANES
from ..parallel.mesh import (DATA_AXIS, Mesh, current_mesh, make_mesh,
                             refuse_unported_axes)
from ..profiling.step_profiler import StepLatencyRing
from ..resilience.constants import TrainingDivergedError
from ..resilience.guard import (ACTION_ABORT, ACTION_ROLLBACK,
                                AnomalyGuard)
from ..resilience.rollback import RollbackManager
from ..resilience.watchdog import StepWatchdog
from ..utils.device import resolve_device
from ..utils.distributed import get_world_size, init_distributed
from ..utils.params import tree_leaves
from . import constants as C
from .config import DeepSpeedConfig, get_mesh_config
from .csr_tensor import CSRTensor, csr_allreduce
from .dataloader import DeepSpeedDataLoader, RepeatingLoader
from .fp16.loss_scaler import DynamicScaleState, update_scale_state
from .activation_checkpointing import checkpointing as ds_checkpointing
from .activation_checkpointing.config import ACT_CHKPT
from .lr_schedules import SCHEDULE_CLASSES
from .progressive_layer_drop import ProgressiveLayerDrop
from .zero import qstate
from .zero.coordinator import FlatParamCoordinator
from .zero.stream import HostStream, chunk_rows_for

logger = logging.getLogger(__name__)


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, mesh=None, device=None,
               auto_resume=False):
    """Build the training engine.  Returns ``(engine, optimizer,
    training_dataloader, lr_scheduler)``, as the JAX package does.
    ``model_parameters`` is the param tree (numpy or tensor leaves); the
    model's ``init(seed)`` makes one when it is None.  ``device=None``
    trains on CUDA (``cuda:LOCAL_RANK`` under a process group) and raises
    without it.  ``mesh``
    (:func:`~deepspeed_tpu_torch.parallel.mesh.make_mesh`) trains
    data-parallel over its ``data`` axis, every rank calling
    ``initialize`` alike; so does an ``mpu``, or a ``mesh`` config block
    (default ``{"data": -1}``: the whole world) once a process group of
    more than one process is up, which ``initialize`` joins from the
    launcher's environment
    (:func:`~deepspeed_tpu_torch.utils.distributed.init_distributed`)
    unless ``dist_init_required=False``.  A world of one process trains
    without a mesh unless one is passed.

    With ``auto_resume=True`` the engine restores the latest committed
    checkpoint under ``resilience.checkpoint_dir`` through its ``latest``
    pointer, and starts fresh (with a warning) when there is none: a
    respawned job lands on its last good step (JAX ``engine.py:130-185``).
    """
    engine = DeepSpeedEngine(
        args=args, model=model, optimizer=optimizer,
        model_parameters=model_parameters, training_data=training_data,
        lr_scheduler=lr_scheduler, mpu=mpu,
        dist_init_required=dist_init_required, collate_fn=collate_fn,
        config=config, config_params=config_params, mesh=mesh,
        device=device)
    if auto_resume:
        load_dir = engine.resilience_config.checkpoint_dir
        if load_dir is None:
            logger.warning(
                "auto_resume: resilience.checkpoint_dir is not configured; "
                "starting fresh (set it so respawned jobs resume)")
        else:
            path, _ = engine.load_checkpoint(load_dir)
            if path is None:
                logger.info(f"auto_resume: no committed checkpoint under "
                            f"{load_dir}; starting fresh")
            else:
                logger.info(f"auto_resume: resumed from {path}")
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


class DeepSpeedEngine:
    """The training engine: one data-parallel rank of ``mesh`` (of a
    world of one without it)."""

    def __init__(self, args=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None,
                 lr_scheduler=None, mpu=None, dist_init_required=None,
                 collate_fn=None, config=None, config_params=None,
                 mesh=None, device=None):
        if model is None:
            raise ValueError("initialize requires a model")
        config = config if config is not None else config_params
        if config is None and args is not None:
            config = getattr(args, "deepspeed_config", None)
        if config is None:
            raise ValueError("DeepSpeed requires --deepspeed_config, a config "
                             "dict, or config_params")
        if dist_init_required or dist_init_required is None:
            init_distributed(device=device)
        if mesh is None and mpu is not None:
            mesh = Mesh.from_mpu(mpu)
        if mesh is None and get_world_size() > 1:
            mesh = make_mesh(get_mesh_config(config))
        if mesh is not None:
            refuse_unported_axes(mesh.shape)
        self.mesh = mesh
        dp = mesh.size(DATA_AXIS) if mesh is not None else 1
        self.dp_world_size = dp
        self.dp_rank = mesh.index(DATA_AXIS) if mesh is not None else 0
        self.mp_world_size = 1
        self._config = DeepSpeedConfig(config, world_size=dp)
        zc = self._config.zero_config
        self._offload = zc.cpu_offload
        if self._offload and self._config.zero_optimization_stage >= 3:
            raise NotImplementedError("ZeRO-3 with cpu_offload is not "
                                      "ported yet (ROADMAP A8)")
        if self._offload and dp > 1:
            raise NotImplementedError(
                "ZeRO-Offload with the host state sharded over "
                "data-parallel ranks is not ported yet (ROADMAP A9); it "
                "runs at one rank")
        if zc.overlap_comm is True and dp > 1:
            raise NotImplementedError(
                "overlap_comm (the bucketed gradient exchange) is not "
                "ported yet (ROADMAP A8); set it to false or \"auto\"")
        self.device = resolve_device(device, "DeepSpeedEngine")
        if self._config.fp16_enabled:
            self.compute_dtype = torch.float16
        elif self._config.bf16_enabled:
            self.compute_dtype = torch.bfloat16
        else:
            self.compute_dtype = torch.float32
        cfg = self._config
        self.dynamic_loss_scale_enabled = (cfg.fp16_enabled
                                           and cfg.loss_scale == 0)
        self.static_loss_scale = (cfg.loss_scale if cfg.fp16_enabled
                                  and cfg.loss_scale != 0 else 1.0)
        self._scale_args = cfg.dynamic_loss_scale_args or {}
        self._scale_state = DynamicScaleState.create(
            init_scale=(cfg.initial_dynamic_scale
                        if self.dynamic_loss_scale_enabled
                        else self.static_loss_scale),
            delayed_shift=self._scale_args.get("delayed_shift", 1))
        self._skipped = 0
        self.resilience_config = cfg.resilience_config
        # the JAX step's `skip_bad`: check the flat gradient for a
        # non-finite value and skip the update on one
        self._skip_bad = cfg.fp16_enabled or self.resilience_config.enabled
        self.module = model
        self._loss_fn = model.apply
        if ACT_CHKPT in cfg._param_dict:
            # the config drives remat, as the reference's
            # checkpointing.configure does
            ds_checkpointing.configure(
                act_config=cfg.activation_checkpointing_config)
            mcfg = getattr(model, "config", None)
            if hasattr(mcfg, "remat") and not mcfg.remat:
                mcfg.remat = True
                logger.info("activation checkpointing enabled from config")

        self._sparse_paths = self._configure_sparse_gradients(model)
        params0 = (model_parameters if model_parameters is not None
                   else model.init(self._config.seed))
        self.flat = FlatParamCoordinator(
            params0, stage=self._config.zero_optimization_stage,
            dp_size=dp, dp_rank=self.dp_rank,
            mesh=None if self._offload else mesh)
        self.segments = self.flat.segments
        self._partitioned = self.flat.partitioned
        self._row_shard = self.flat.row_shard()
        self.optimizer = self._configure_basic_optimizer(optimizer)
        if self._offload:
            self._build_offload(params0)
        else:
            self.master = self.flat.flatten_to_master(params0, self.device)
            self.opt_state = self.optimizer.init_state(self.master)
            self._quant, self._qres = None, {}
        del params0
        self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler)
        self.progressive_layer_drop = (ProgressiveLayerDrop(
            theta=cfg.pld_params["theta"], gamma=cfg.pld_params["gamma"])
            if cfg.pld_enabled else None)

        # compute params: one flat buffer; the param dict is its views,
        # each an autograd leaf whose .grad is a view of one flat buffer
        self._compute = torch.empty(self.flat.flat_shape,
                                    dtype=self.compute_dtype,
                                    device=self.device)
        self._grad = torch.zeros_like(self._compute)
        self.params = self.flat.unflatten_params(self._compute)
        grads = self.flat.unflatten_params(self._grad)
        _attach_grads(self.params, grads)
        acc = self.gradient_accumulation_steps()
        # the JAX rule: the gradient keeps the compute dtype only where
        # nothing sums into it (one rank, no accumulation); the exchange
        # and the accumulation sum in fp32
        summed = acc > 1 or dp > 1
        stage2 = self._partitioned and self._config.zero_optimization_stage \
            == 2
        self._acc = (torch.zeros(self.flat.flat_shape, dtype=torch.float32,
                                 device=self.device)
                     if summed and not stage2
                     and self.compute_dtype != torch.float32 else None)
        # the rank's rows of the reduced gradient, in the exchange's
        # dtype (stage 2 accumulates the micro-batches there)
        self._gshard = (torch.zeros(
            self.flat.shard_shape,
            dtype=torch.float32 if summed else self.compute_dtype,
            device=self.device) if self._partitioned else None)
        self._step_loss = None
        self._step_tokens = 0   # the step's input tokens on this rank
        self._in_train_batch = False
        self._refresh_params()

        self.training_dataloader = None
        if training_data is not None:
            # the global micro-batch, of which this rank keeps its slice
            self.training_dataloader = DeepSpeedDataLoader(
                training_data, self.train_micro_batch_size_per_gpu() * dp,
                collate_fn=collate_fn, seed=self._config.seed,
                data_parallel_world_size=dp,
                data_parallel_rank=self.dp_rank)
        self._train_iter = None
        self.global_steps = 0
        self.micro_steps = 0
        self.global_samples = 0
        self._losses = []
        self._step_seconds = []

        self.checkpoint_config = self._config.checkpoint_config
        self._ckpt_manager = CheckpointManager(self.checkpoint_config)
        self._last_ckpt_dir = None
        if self.checkpoint_config.save_on_preemption:
            self._ckpt_manager.install_preemption_handler(
                self._preemption_save)
        self._build_resilience()
        logger.info("engine on %s: %d parameters in %d tensors, flat %s, "
                    "compute %s, optimizer %s, ZeRO stage %d, data-parallel "
                    "rank %d of %d", self.device,
                    sum(self.segments.sizes), self.segments.num_segments,
                    self.flat.flat_shape, self.compute_dtype,
                    type(self.optimizer).__name__,
                    self._config.zero_optimization_stage, self.dp_rank, dp)

    # ------------------------------------------------------------ config
    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def steps_per_print(self):
        return self._config.steps_per_print

    def zero_optimization_stage(self):
        return self._config.zero_optimization_stage

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def bfloat16_enabled(self):
        return self._config.bf16_enabled

    def fp16_enabled(self):
        return self._config.fp16_enabled

    def dynamic_loss_scale(self):
        return self.dynamic_loss_scale_enabled

    @property
    def loss_scale(self):
        return self._scale_state.cur_scale

    @property
    def skipped_steps(self):
        return self._skipped

    def wall_clock_breakdown(self):
        return self._config.wall_clock_breakdown

    def progressive_layer_drop_enabled(self):
        return self._config.pld_enabled

    def get_lr(self):
        return [g["lr"] for g in self.optimizer.param_groups]

    def _configure_basic_optimizer(self, client_optimizer):
        if client_optimizer is not None:
            if not all(hasattr(client_optimizer, attr)
                       for attr in ("init_state", "update", "hyperparams")):
                raise TypeError("client optimizer must implement init_state/"
                                "update/hyperparams (flat-optimizer "
                                "protocol)")
            if (self._config.zero_enabled
                    and not self._config.zero_allow_untested_optimizer
                    and type(client_optimizer).__name__ not in (
                        "FusedAdam", "FusedLamb", "DeepSpeedCPUAdam")):
                raise ValueError("ZeRO with a client optimizer requires "
                                 '"zero_allow_untested_optimizer": true')
            return client_optimizer
        name = (self._config.optimizer_name or C.ADAM_OPTIMIZER).lower()
        params = dict(self._config.optimizer_params or {})
        params.pop(C.MAX_GRAD_NORM, None)
        if name in (C.ADAM_OPTIMIZER, "adamw"):
            return FusedAdam(adam_w_mode=(name == "adamw"
                                          or params.pop("adam_w_mode", True)),
                             **params)
        if name == C.LAMB_OPTIMIZER:
            return FusedLamb(**params)
        if name in ("cpuadam", "cpu_adam", "deepspeedcpuadam"):
            if self.device.type == "cuda" and not self._offload:
                raise ValueError(
                    "DeepSpeedCPUAdam updates host buffers: on the card it "
                    "needs zero_optimization.cpu_offload: true")
            return cpu_adam.DeepSpeedCPUAdam(**params)
        if name == C.ONEBIT_ADAM_OPTIMIZER:
            raise NotImplementedError("1-bit Adam is not ported yet (ROADMAP "
                                      "A14)")
        raise ValueError(f"Unknown optimizer {name!r}")

    def _configure_sparse_gradients(self, model):
        """The leaves whose gradients exchange row-sparse under
        ``sparse_gradients`` (JAX ``engine.py:280-304``): the model's
        ``sparse_gradient_paths()``, at ZeRO stage 0 only (the sharded
        stages cannot carry a row-sparse exchange) and not under fp16
        (its overflow skip would swallow the budget-overflow poison)."""
        cfg = self._config
        if not cfg.sparse_gradients_enabled:
            return ()
        if cfg.zero_optimization_stage != 0:
            raise ValueError(
                f"sparse_gradients: true requires ZeRO stage 0, got "
                f"stage={cfg.zero_optimization_stage}: the row-sparse "
                f"(indices, values) exchange cannot ride a sharded flat "
                f"parameter space.  Disable sparse_gradients or set "
                f"zero_optimization.stage: 0.")
        if cfg.fp16_enabled:
            raise ValueError(
                "sparse_gradients does not compose with fp16 loss scaling "
                "(overflow-skip would mask budget-overflow detection); use "
                "bf16 or fp32")
        paths = tuple(getattr(model, "sparse_gradient_paths", tuple)())
        logger.info("sparse_gradients: embedding leaves %s exchange as "
                    "row-sparse (indices, values) pairs over the data axis",
                    paths or "(none declared)")
        return paths

    def sparse_gradients_enabled(self):
        return self._config.sparse_gradients_enabled

    def sparse_gradient_paths(self):
        """The leaves whose gradients take the row-sparse exchange."""
        return self._sparse_paths

    def _configure_lr_scheduler(self, client_scheduler):
        if client_scheduler is not None:
            return client_scheduler
        name = self._config.scheduler_name
        if name is None:
            return None
        if name not in SCHEDULE_CLASSES:
            raise ValueError(f"Unknown lr schedule {name!r}")
        return SCHEDULE_CLASSES[name](self.optimizer,
                                      **(self._config.scheduler_params or {}))

    # ----------------------------------------------------------- offload
    def _build_offload(self, params0):
        """Host state for ``cpu_offload`` (JAX ``engine.py:480-660``): the
        master and the optimizer's flat state in their storage dtypes,
        pinned on the card's host, zero-initialized there (every flat
        optimizer here is zeros plus a step count); the residuals of
        error feedback; the fp32 host gradient of ``offload_gradients``
        and of the host optimizer; and the chunk stream."""
        zc = self._config.zero_config
        name = getattr(self.optimizer, "name", "")
        pin = self.device.type == "cuda"
        sd = zc.offload_state_dtype
        if zc.offload_state_reduced and name != "adam":
            raise ValueError("offload_state_dtype with reduced dtypes "
                             "requires the flat Adam optimizer (the chunk-"
                             "streamed update the compression rides)")
        self._offload_grads = zc.offload_gradients
        if self._offload_grads:
            if name != "adam":
                raise ValueError("offload_gradients requires the flat Adam "
                                 "optimizer (the chunk-streamed update)")
            if self.gradient_accumulation_steps() > 1:
                raise ValueError(
                    "offload_gradients does not yet support "
                    "gradient_accumulation_steps > 1 (the host gradient "
                    "buffer is written once per step)")
        if zc.offload_overlap is True and zc.offload_prefetch_depth < 2:
            raise ValueError(
                "offload_overlap: true contradicts offload_prefetch_depth: "
                "1 (a one-deep pipeline IS the serialized schedule); raise "
                "the depth or drop offload_overlap")
        self.master = self.flat.flatten_to_host(
            params0, qstate.STATE_DTYPES[sd["master"]], pin)
        if name in ("adam", "cpu_adam", "lamb"):
            by_name = {"exp_avg": sd["momentum"], "exp_avg_sq": sd["variance"]}
            shape = self.optimizer.init_state(
                torch.empty((1, 1), dtype=torch.float32))
            self.opt_state = dataclasses.replace(shape, **{
                f: self.flat.host_buffer(
                    qstate.STATE_DTYPES[by_name.get(f, "fp32")], pin)
                for f, v in state_fields(shape).items()
                if isinstance(v, torch.Tensor)})
        else:
            # a client optimizer: its own init on the host master, pinned
            self.opt_state = self.optimizer.init_state(self.master)
            if pin:
                self.opt_state = dataclasses.replace(self.opt_state, **{
                    f: v.pin_memory()
                    for f, v in state_fields(self.opt_state).items()
                    if isinstance(v, torch.Tensor)})
        leaves = [(f, isinstance(v, torch.Tensor))
                  for f, v in state_fields(self.opt_state).items()]
        self._flat_fields = [f for f, flat in leaves if flat]
        self._quant = qstate.build_state_quant(sd, leaves)
        self._qres = {}
        if self._quant is not None:
            for res in self._quant.residual_names():
                self._qres[res] = self.flat.host_buffer(
                    self._quant.dtype_of(res), pin)
        self._host_grad = (self.flat.alloc_host_grads(pin)
                           if self._offload_grads or name == "cpu_adam"
                           else None)
        chunk_rows = chunk_rows_for(zc.offload_chunk_mb)
        depth = (zc.offload_prefetch_depth
                 if zc.offload_overlap is not False else 1)
        self._streams_update = name == "adam"
        # Adam streams in chunks and CPUAdam moves its gradient and params
        # in them; other optimizers (Lamb's per-tensor norms) take the
        # whole state in one job, the one-shot update
        self._stream = HostStream(
            self.segments.rows,
            chunk_rows if name in ("adam", "cpu_adam") else None, depth,
            self.device)
        self._host_state_bytes = qstate.host_state_bytes_per_step(
            self.segments.rows, self.segments.shape[1], self._quant,
            n_flat_leaves=len(self._flat_fields))
        logger.info("ZeRO-Offload: host state %s, %s update, schedule %s",
                    self.host_state_dtype(),
                    "streamed" if self._streams_update else name,
                    self.host_stream_schedule())

    def zero_cpu_offload(self):
        return self._config.zero_config.cpu_offload

    def host_state_dtype(self):
        """Storage dtype of the offloaded host state: one name when the
        master and both moments agree, else "mixed"."""
        sd = self._config.zero_config.offload_state_dtype
        names = {sd["master"], sd["momentum"], sd["variance"]}
        return sd["master"] if len(names) == 1 else "mixed"

    def host_state_bytes_per_step(self):
        """Bytes the streamed update moves a step for the host state
        (both directions; gradients apart).  None without offload."""
        return self._host_state_bytes if self._offload else None

    def host_stream_schedule(self):
        """The streamed update's schedule (``{overlap, prefetch_depth,
        chunks, groups, form}``); None when the update does not stream
        (no offload, the one-shot update, the host optimizer)."""
        if not self._offload or not self._streams_update:
            return None
        return self._stream.schedule()

    @property
    def host_stream(self):
        """The :class:`~deepspeed_tpu_torch.runtime.zero.stream.HostStream`
        that moves the host state (set its ``timing`` to time the copies;
        ``timing_report()`` reads them); None without offload."""
        return self._stream if self._offload else None

    def _sync_host(self):
        """Wait for every copy to or from the host buffers: before the
        host reads or writes them."""
        if self._offload:
            self._stream.sync_host()

    def _offload_update(self, g):
        """The update under offload, the gradient ``g`` on the card
        already unscaled and clipped."""
        hp = self.optimizer.hyperparams()
        if getattr(self.optimizer, "name", "") == "cpu_adam":
            self._stream.spill(g, self._host_grad)
            self._stream.sync_host()
            self.optimizer.update(self.opt_state, self.master,
                                  self._host_grad, hp)
            self._params_from_host()
            return
        stream = self._stream
        host = {"master": self.master}
        fields = state_fields(self.opt_state)
        for f in self._flat_fields:
            host[f] = fields[f]
        for res, buf in self._qres.items():
            host["res/" + res] = buf
        writes = tuple(host)
        if self._offload_grads:
            stream.spill(g, self._host_grad)
            host["grad"] = self._host_grad
        quant, step0 = self._quant, self.opt_state.step

        def chunk(k, r0, rc, v):
            pm = (quant.load(v["master"], v.get("res/master")) if quant
                  else v["master"])
            leaves = {f: quant.load(v[f], v.get("res/" + f)) if quant
                      else v[f] for f in self._flat_fields}
            st = dataclasses.replace(self.opt_state, **leaves)
            gc = v["grad"] if "grad" in v else g[r0:r0 + rc]
            self.optimizer.update(st, pm, gc, hp, segments=self.segments)
            if quant is not None:
                for slot, name in enumerate(["master", *self._flat_fields]):
                    val = pm if name == "master" else getattr(st, name)
                    q, r = quant.store(val, quant.dtype_of(name),
                                       step=step0 + 1, tag=k,
                                       slot=slot)
                    v[name].copy_(q)
                    if r is not None:
                        v["res/" + name].copy_(r)
            # the folded param cast, from the stored master
            self._compute[r0:r0 + rc].copy_(v["master"])

        stream.run(host, chunk, writes)
        self.opt_state.step = step0 + 1

    def _params_from_host(self):
        """The compute params as the cast of the host master, streamed up
        in chunks and cast on the card (for DeepSpeedCPUAdam this beat a
        cast on the host and a 2-byte copy: ``ops/adam/cpu_adam.py``)."""
        def cast(k, r0, rc, v):
            self._compute[r0:r0 + rc].copy_(v["master"])

        self._stream.run({"master": self.master}, cast)

    # -------------------------------------------------------- resilience
    def _build_resilience(self):
        """The anomaly guard, the rollback manager and the step watchdog
        of an enabled ``resilience`` block (JAX ``engine.py:805-840``);
        the telemetry sinks stay unset until ROADMAP A12."""
        rcfg = self.resilience_config
        self._guard = None
        self._rollback_mgr = None
        self._watchdog = None
        self._step_latencies = None
        if not rcfg.enabled:
            return
        self._guard = AnomalyGuard(
            policy=rcfg.policy, spike_window=rcfg.spike_window,
            spike_zscore=rcfg.spike_zscore,
            divergence_patience=rcfg.divergence_patience,
            floor_scale_patience=rcfg.floor_scale_patience,
            min_scale=float(self._scale_args.get("min_scale", 1.0)),
            fp16=self._config.fp16_enabled)
        self._rollback_mgr = RollbackManager(
            self, max_rollbacks=rcfg.max_rollbacks,
            cooldown_steps=rcfg.rollback_cooldown_steps,
            checkpoint_dir=rcfg.checkpoint_dir)
        if rcfg.hang_timeout_secs > 0:
            self._step_latencies = StepLatencyRing()
            self._watchdog = StepWatchdog(
                rcfg.hang_timeout_secs, latency_ring=self._step_latencies,
                describe=lambda: (f"global_step={self.global_steps} "
                                  f"micro_steps={self.micro_steps}")).start()
        logger.info(f"resilience enabled: {rcfg}")

    def _step_beat(self):
        """One completed step: the watchdog's heartbeat (which feeds the
        latency ring), or the ring alone.  Host work only."""
        if self._watchdog is not None:
            self._watchdog.beat()
        elif self._step_latencies is not None:
            self._step_latencies.beat()

    def _step_beat_pause(self):
        """Forget the last beat across a known-long gap (a rollback's
        restore, a synchronous final save)."""
        if self._watchdog is not None:
            self._watchdog.pause()
        if self._step_latencies is not None:
            self._step_latencies.pause()

    def _apply_guard_action(self, action):
        """Escalate an anomaly-guard verdict (JAX ``engine.py:3750-3805``).
        Returns True when a rollback restored earlier state; raises
        :class:`~deepspeed_tpu_torch.resilience.constants.TrainingDivergedError`
        on abort, or when a rollback is impossible."""
        if action == ACTION_ROLLBACK:
            # the restore can outlast the hang timeout: disarm until the
            # caller's beat after it
            self._step_beat_pause()
            reason = (f"{self._guard.consecutive_anomalies} consecutive "
                      f"anomalous step(s)")
            try:
                self._rollback_mgr.rollback(reason=reason)
            except TrainingDivergedError:
                if self._watchdog is not None:
                    self._watchdog.stop()
                raise
            self._guard.notify_rollback()
            return True
        if action == ACTION_ABORT:
            if self._watchdog is not None:
                # the abort's teardown must not race the watchdog's
                # respawnable exit
                self._watchdog.stop()
            raise TrainingDivergedError(
                f"training diverged at step {self.global_steps}: "
                f"{self._guard.consecutive_anomalies} consecutive anomalous "
                f"step(s) under policy={self._guard.policy}; recent "
                f"anomalies: {self._guard.recent_events()[-5:]}")
        return False

    # ------------------------------------------------------------- state
    def _refresh_params(self):
        """Cast the master into the compute params (in place: the param
        dict's views see it); under offload, from the host master;
        partitioned, each rank casts its rows and one all-gather in the
        compute dtype assembles them (JAX ``_gather_cast_leaves``,
        ``engine.py:2947-2985``)."""
        with torch.no_grad():
            if self._offload:
                self._params_from_host()
            elif self._partitioned:
                comm.all_gather(self.master.to(self.compute_dtype),
                                DATA_AXIS, mesh=self.mesh, out=self._compute)
            else:
                self._compute.copy_(self.master)

    def _to_device(self, batch):
        """A host batch (numpy or tensor leaves) on the engine's device:
        integer arrays as int64, copied through pinned memory without a
        sync on CUDA."""
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._to_device(v) for v in batch)
        t = batch if isinstance(batch, torch.Tensor) else \
            torch.from_numpy(np.asarray(batch))
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        if t.device == self.device:
            return t
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # ------------------------------------------------------------- steps
    def forward(self, batch):
        """The training loss of one micro-batch, with its graph (call
        :meth:`backward` on it).  Dropout draws from streams seeded by the
        config ``seed``, the micro-step count and, above rank 0, the
        data-parallel rank.  Under Progressive
        Layer Drop the model also gets ``pld_theta``, θ as a 0-d fp32
        tensor on the device."""
        if self._offload and self._offload_grads \
                and not self._in_train_batch:
            raise RuntimeError(
                "offload_gradients supports only train_batch() (the "
                "step-wise forward/backward API is not its path)")
        rng = mix_seed(self._config.seed, self.micro_steps)
        if self.dp_rank:
            # each rank its own streams; rank 0 draws the one-rank ones
            rng = mix_seed(rng, self.dp_rank)
        kwargs = {}
        if self.progressive_layer_drop is not None:
            kwargs["pld_theta"] = self._to_device(torch.tensor(
                self.progressive_layer_drop.get_theta(),
                dtype=torch.float32))
        if self._sparse_paths and isinstance(batch, dict) \
                and "input_ids" in batch:
            self._step_tokens += int(np.prod(np.shape(batch["input_ids"])))
        return self._loss(batch, rng=rng, train=True, **kwargs)

    __call__ = forward

    def _loss(self, batch, **kwargs):
        """The model's loss on ``batch``, with the engine's mesh current
        for the call only: a loss that counts items (labels, unmasked
        keys) divides by the global batch's count through it
        (:func:`~deepspeed_tpu_torch.comm.data_parallel_mean_count`), a
        collective that the engine's callers make on every rank."""
        with current_mesh(self.mesh):
            return self._loss_fn(self.params, self._to_device(batch),
                                 **kwargs)

    def backward(self, loss):
        """Gradients of ``loss`` × the loss scale / (accumulation steps ×
        data-parallel ranks) into the flat gradient buffer
        (fp32-accumulated across micro-batches under bf16 or fp16 with
        accumulation, and above one rank).  The scale is 1 without fp16,
        and then no multiply is made.  Under ZeRO-2 the micro-batch's
        gradient is reduce-scattered here onto its owners' rows."""
        scaled = loss.float()
        if self._config.fp16_enabled:
            scaled = scaled * self._scale_state.cur_scale
        (scaled / (self.gradient_accumulation_steps()
                   * self.dp_world_size)).backward()
        if self._partitioned and self._config.zero_optimization_stage == 2:
            self._reduce_scatter_grad(
                accumulate=self.gradient_accumulation_steps() > 1)
            self._grad.zero_()
        elif self._acc is not None:
            self._acc.add_(self._grad)
            self._grad.zero_()
        self._losses.append(loss.detach())
        self.micro_steps += 1
        self.global_samples += (self.train_micro_batch_size_per_gpu()
                                * self.dp_world_size)
        return loss

    def _reduce_scatter_grad(self, accumulate):
        """The summed gradient's rows this rank owns, into ``_gshard``
        (added to it with ``accumulate``): the full flat gradient, in
        ``_gshard``'s dtype, reduce-scattered over the data axis."""
        src = self._acc if self._acc is not None else self._grad
        src = src.to(self._gshard.dtype)
        if accumulate:
            self._gshard.add_(comm.reduce_scatter(src, DATA_AXIS,
                                                  mesh=self.mesh))
        else:
            comm.reduce_scatter(src, DATA_AXIS, mesh=self.mesh,
                                out=self._gshard)

    def _exchange_gradient(self):
        """The step's gradient after the exchange (JAX ``engine.py:1896-1913``
        for the dtype): this rank's rows of the sum over the ranks
        (stages 1, 2), or the whole sum on every rank (stage 0; declared
        embedding leaves row-sparse under ``sparse_gradients``); the
        local gradient without a mesh."""
        if self._partitioned:
            if self._config.zero_optimization_stage == 1:
                self._reduce_scatter_grad(accumulate=False)
            return self._gshard
        g = self._acc if self._acc is not None else self._grad
        if self.mesh is None:
            return g
        if not self._sparse_paths:
            return comm.psum(g, DATA_AXIS, self.mesh, out=g)
        return self._sparse_exchange(g)

    def _sparse_exchange(self, g):
        """Stage 0 under ``sparse_gradients`` (JAX ``engine.py:2789-2870``):
        every declared leaf's gradient goes through the row-sparse
        all-gather with a budget of the step's tokens a rank (the support
        of an embedding lookup's gradient), and the rows between them
        through all-reduces.  A leaf whose gradient has more non-zero
        rows than the budget (a tied head: its gradient is dense) is
        poisoned with NaN on every rank, so the step fails loudly
        instead of training on truncated gradients."""
        view = g.view(-1)
        bounds, dense_from = [], 0
        _, leaves = tree_leaves(self.flat.unflatten_params(g))
        for i, (path, leaf) in enumerate(zip(self.flat.paths, leaves)):
            if ("/".join(path) not in self._sparse_paths or leaf.dim() != 2
                    or not 0 < self._step_tokens < leaf.shape[0]):
                continue
            ro = self.segments.row_offsets[i]
            bounds.append((dense_from * LANES, ro * LANES))
            dense_from = ro + self.segments.row_counts[i]
            csr, dropped = CSRTensor.from_dense(
                leaf, max_rows=self._step_tokens, return_dropped=True)
            summed = csr_allreduce(csr, DATA_AXIS, self.mesh)
            dropped = comm.psum(dropped.float(), DATA_AXIS, self.mesh)
            leaf.copy_(summed + torch.where(dropped > 0, float("nan"),
                                            0.0).to(summed.dtype))
        bounds.append((dense_from * LANES, view.numel()))
        for lo, hi in bounds:
            if hi > lo:
                part = view[lo:hi]
                comm.psum(part, DATA_AXIS, self.mesh, out=part)
        return g

    def is_gradient_accumulation_boundary(self):
        return self.micro_steps % self.gradient_accumulation_steps() == 0

    def step(self):
        """At the accumulation boundary: exchange the gradient over the
        data-parallel ranks, clip by global norm, update the master (this
        rank's rows of it under ZeRO-1/2) in fp32, cast it into the
        compute params, step the LR schedule.  Under fp16 or resilience
        the gradient is checked for a non-finite value in the step's one
        batched fetch, and a non-finite one skips the update (and the LR
        step); fp16 unscales before clipping and moves a dynamic scale
        after; the anomaly guard then sees the step.  Under a mesh the
        flag, the loss and the gradient's sum of squares go through one
        all-reduce before that fetch, so every rank decides alike."""
        if not self.is_gradient_accumulation_boundary():
            return
        overflow, mean_loss = False, None
        with torch.no_grad():
            g = self._exchange_gradient()
            zero = torch.zeros((), dtype=torch.float32, device=self.device)
            flag = (torch.logical_not(torch.isfinite(g).all()).float()
                    if self._skip_bad else zero)
            loss = torch.stack(self._losses).float().mean()
            # an overflowed step discards g, so unscaling first is safe
            g = self._unscale(g)
            clip = float(self.gradient_clipping() or 0.0)
            norm = (torch.linalg.vector_norm(g, dtype=torch.float32)
                    if clip > 0.0 else None)
            if self.mesh is not None:
                # a sharded gradient's norm is the root of the ranks'
                # summed squares; stage 0's is whole on every rank
                sharded = norm is not None and self._partitioned
                stats = comm.psum(
                    torch.stack([flag, loss, norm * norm if sharded
                                 else zero]), DATA_AXIS, self.mesh)
                flag, loss = stats[0], stats[1] / self.dp_world_size
                if sharded:
                    norm = stats[2].sqrt()
            self._step_loss = loss
            if self._skip_bad:
                # the one host sync of the step: the overflow flag and the
                # mean loss in one copy
                fetched = torch.stack([flag, loss]).tolist()
                overflow, mean_loss = fetched[0] > 0, fetched[1]
            if not overflow:
                if norm is not None:
                    coef = torch.clamp(clip / (norm + 1e-6), max=1.0)
                    g = g * coef.to(g.dtype)
                if self._offload:
                    # writes the compute params chunk by chunk
                    self._offload_update(g)
                else:
                    shard = ({"shard": self._row_shard}
                             if self._partitioned else {})
                    self.optimizer.update(self.opt_state, self.master, g,
                                          self.optimizer.hyperparams(),
                                          segments=self.segments, **shard)
            if not self._offload or overflow:
                # after a skipped step too: the compute params are the
                # master's cast, whatever wrote into them (an offload
                # update writes them chunk by chunk itself)
                self._refresh_params()
            self._grad.zero_()
            if self._acc is not None:
                self._acc.zero_()
            if self._partitioned and self.gradient_accumulation_steps() > 1:
                self._gshard.zero_()
            self._step_tokens = 0
        if self.dynamic_loss_scale_enabled:
            args = self._scale_args
            self._scale_state = update_scale_state(
                self._scale_state, overflow,
                scale_window=args.get("scale_window", 1000),
                min_scale=args.get("min_scale", 1.0),
                delayed_shift=args.get("delayed_shift", 1))
        self._skipped += int(overflow)
        self.global_steps += 1
        if self._guard is not None:
            action = self._guard.observe(
                mean_loss, overflow, scale=self._scale_state.cur_scale,
                step=self.global_steps)
            if self._apply_guard_action(action):
                # rolled back: counters, schedule and scale state are the
                # checkpoint's; this step's bookkeeping is void
                self._losses = []
                self._step_beat()
                return
        if self.lr_scheduler is not None and not overflow:
            self.lr_scheduler.step()
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)
        if self.global_steps % self.steps_per_print() == 0:
            if mean_loss is None:
                # the print cadence's one host sync
                mean_loss = float(self._step_loss)
            msg = (f"step={self.global_steps}, skipped={self._skipped}, "
                   f"lr={self.get_lr()[0]:.6g}, loss={mean_loss:.5f}, "
                   f"loss_scale={self.loss_scale}")
            if self._step_seconds:
                msg += (f", train_batch ms (synchronized)="
                        f"{1e3 * np.mean(self._step_seconds):.2f}")
                self._step_seconds = []
            logger.info(msg)
        self._losses = []
        self._step_beat()

    def _unscale(self, g):
        """The flat gradient divided by the loss scale (itself when the
        scale is 1): in the gradient's dtype where 1/scale is exact in it,
        as the JAX engine multiplies (``:3178-3180``), else in fp32.  In
        fp16 1/scale is exact up to a scale of 2^24; above it the JAX
        engine's fp16 1/scale is 0 and a finite step applies a zero
        gradient (ROADMAP C), which the fp32 multiply avoids."""
        scale = self._scale_state.cur_scale
        if scale == 1.0:
            return g
        inv = float(np.float32(1.0) / np.float32(scale))
        exact = float(torch.tensor(inv, dtype=g.dtype)) == inv
        if exact:
            return g.mul_(inv)
        return g.float().mul_(inv)

    def train_batch(self, data_iter=None):
        """One optimizer step over ``gradient_accumulation_steps``
        micro-batches drawn from ``data_iter`` (default: the training
        dataloader, repeated; under a mesh, this rank's micro-batches).
        Returns the mean loss as a device tensor (over every rank's
        micro-batches under a mesh); without fp16 and resilience it
        fetches nothing from the card
        (see :meth:`step`).  Under
        ``wall_clock_breakdown`` the step is timed between two
        synchronizations, which the log reports at the print cadence."""
        if data_iter is None:
            if self.training_dataloader is None:
                raise ValueError("train_batch() without an iterator needs "
                                 "initialize(training_data=...)")
            if self._train_iter is None:
                self._train_iter = iter(RepeatingLoader(
                    self.training_dataloader))
            data_iter = self._train_iter
        if self.micro_steps % self.gradient_accumulation_steps():
            raise RuntimeError("train_batch() cannot run with un-stepped "
                               "forward()/backward() micro-batches pending")
        timed = self.wall_clock_breakdown() and self.device.type == "cuda"
        if timed:
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
        losses = []
        self._in_train_batch = True
        try:
            for _ in range(self.gradient_accumulation_steps()):
                loss = self.forward(next(data_iter))
                self.backward(loss)
                losses.append(loss.detach())
        finally:
            self._in_train_batch = False
        if timed:
            torch.cuda.synchronize(self.device)
            self._step_seconds.append(time.perf_counter() - t0)
        self.step()
        return self._step_loss

    def eval_batch(self, batch):
        """Loss with ``train=False`` on one batch, or the mean over
        ``gradient_accumulation_steps`` batches drawn from an iterator;
        under a mesh, each rank's batch is its slice and a loss (a 0-d
        result) is averaged over the ranks."""
        with torch.no_grad():
            if not hasattr(batch, "__next__"):
                return self._rank_mean(self._loss(batch, rng=None,
                                                  train=False))
            losses = []
            for _ in range(max(1, self.gradient_accumulation_steps())):
                try:
                    item = next(batch)
                except StopIteration:
                    break
                losses.append(self._loss(item, rng=None, train=False))
            if not losses:
                raise ValueError("eval_batch received an exhausted iterator")
            return self._rank_mean(torch.stack(losses).mean(dim=0))

    def _rank_mean(self, out):
        """A 0-d loss averaged over the data-parallel ranks; anything
        else (logits) as it is."""
        if self.mesh is None or not isinstance(out, torch.Tensor) \
                or out.dim() != 0:
            return out
        return comm.pmean(out.float(), DATA_AXIS, self.mesh)

    def get_master_params(self):
        """The fp32 master as a param dict (views of the flat buffer; of
        an fp32 copy where the host master is stored reduced, or of the
        ranks' rows gathered under ZeRO-1/2, which every rank calls)."""
        self._sync_host()
        master = self.master.float()
        if self._partitioned:
            master = comm.all_gather(master, DATA_AXIS, mesh=self.mesh)
        return self.flat.unflatten_params(master)

    # -------------------------------------------------------- checkpoints
    def _params_to_host(self):
        """The compute params as {checkpoint key: CPU tensor}: views of
        ONE host copy of the flat compute buffer, which no step writes.
        The key is the ``/``-joined tree path, the JAX package's
        ``tree_path_key``."""
        host = self._compute.detach().to("cpu", copy=True)
        paths, leaves = tree_leaves(self.flat.unflatten_params(host))
        return {"/".join(path): leaf for path, leaf in zip(paths, leaves)}

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True, sync=None):
        """Save model, optimizer and engine state in the JAX package's
        layout.  The device->host gather happens here; with
        ``checkpoint.async_save`` (the default) serialization and the
        atomic commit run on a background thread and training resumes at
        once.  ``sync=True`` commits inline for this call.  Under a mesh
        every rank calls it (the master and the moments are gathered
        from every rank's rows) and rank 0 alone writes, moving the
        ``latest`` pointer and applying retention."""
        tag = tag or f"global_step{self.global_steps}"
        snapshot = capture_engine_snapshot(self, tag, client_state,
                                           save_latest)
        self._last_ckpt_dir = save_dir
        if self.dp_rank != 0:
            return True
        async_save = (self.checkpoint_config.async_save if sync is None
                      else not sync)
        ok = self._ckpt_manager.save(snapshot, save_dir,
                                     async_save=async_save)
        if not ok:
            # a sync commit that failed raises instead of returning a
            # flag no caller checks
            raise CheckpointError(
                f"checkpoint {tag} save to {save_dir} failed"
            ) from self._ckpt_manager.last_error
        return ok

    def wait_checkpoint(self, save_dir=None, timeout=None):
        """Block until pending async saves finish (for ``save_dir``, or
        all of this engine's); raises
        :class:`~deepspeed_tpu_torch.checkpoint.writer.CheckpointError` if
        the most recent commit failed.  Under a mesh every rank calls it:
        rank 0 waits for its writes and every rank learns the outcome, so
        a load on any rank after it reads the commit."""
        error, drained = None, True
        if self.dp_rank == 0:
            try:
                drained = self._ckpt_manager.wait(save_dir, timeout)
            except CheckpointError as e:
                error = e
        if self.mesh is not None:
            flags = comm.psum(torch.tensor(
                [float(error is not None), float(not drained)],
                device=self.device), DATA_AXIS, self.mesh).tolist()
            if flags[0] > 0 and error is None:
                raise CheckpointError("the checkpoint commit on data-"
                                      "parallel rank 0 failed")
            drained = flags[1] == 0
        if error is not None:
            raise error
        return drained

    def _preemption_save(self):
        """Final synchronous save on SIGTERM, into the last save dir."""
        if self._last_ckpt_dir is None:
            logger.warning("preemption save skipped: no checkpoint dir seen "
                           "yet (call save_checkpoint once to set it)")
            return
        self._step_beat_pause()
        self.save_checkpoint(self._last_ckpt_dir,
                             tag=f"global_step{self.global_steps}", sync=True)

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True, strict=False):
        """Restore a checkpoint that either package wrote; returns
        ``(path, client_state)``.  The unpadded master and moments are
        re-padded into this engine's layout, whatever ZeRO stage or
        data-parallel degree wrote them (under a mesh every rank calls it
        and takes its rows).

        With ``strict=False`` a missing or unverifiable checkpoint warns
        and returns ``(None, None)``; ``strict=True`` raises.  Integrity
        is checked against ``manifest.json`` under
        ``checkpoint.verify_on_load``; directories from before manifests
        load unverified."""
        drain_inflight(load_dir)  # a same-process async save may be landing
        if self.mesh is not None:
            # rank 0's commit lands before any rank reads `latest`
            comm.barrier(DATA_AXIS, self.mesh)

        def _missing(msg, exc=CheckpointError):
            if strict:
                raise exc(msg)
            logger.warning(f"{msg}, cannot load")
            return None, None

        if tag is None:
            tag = ckpt.read_latest(load_dir)
            if tag is None:
                return _missing(f"no '{LATEST_FILE}' file in {load_dir}")
        ckpt_dir = os.path.join(load_dir, str(tag))
        if not os.path.isdir(ckpt_dir):
            # a crash inside a same-tag re-save's rename window leaves the
            # previous committed dir parked at <tag>.old: heal it
            if not ckpt.recover_tag(load_dir, tag):
                return _missing(f"checkpoint dir {ckpt_dir} missing")
        if not os.path.isfile(os.path.join(ckpt_dir, META_JSON)):
            return _missing(f"checkpoint dir {ckpt_dir} has no {META_JSON} "
                            "(torn or foreign directory)")
        if self.checkpoint_config.verify_on_load:
            status, problems = ckpt.verify_checkpoint(ckpt_dir)
            if status == "bad":
                return _missing(f"checkpoint {ckpt_dir} failed integrity "
                                f"verification: {'; '.join(problems)}",
                                exc=CheckpointCorruptionError)
            if status == "legacy":
                logger.info(f"checkpoint {ckpt_dir} predates manifests; "
                            "loading without integrity verification")

        with open(os.path.join(ckpt_dir, META_JSON)) as f:
            meta = json.load(f)
        self._sync_host()
        with np.load(os.path.join(ckpt_dir, OPTIM_STATES_NPZ)) as opt_npz:
            self._restore_flat_state(opt_npz, meta, load_optimizer_states)
        with torch.no_grad():
            self._refresh_params()
            self._grad.zero_()
            if self._acc is not None:
                self._acc.zero_()
        self._losses = []

        ss = meta["scale_state"]
        self._scale_state = DynamicScaleState(
            cur_scale=float(ss["cur_scale"]), cur_iter=int(ss["cur_iter"]),
            last_overflow_iter=int(ss["last_overflow_iter"]),
            cur_hysteresis=int(ss["cur_hysteresis"]))
        self._skipped = int(meta["skipped_steps"])
        self.global_steps = meta["global_steps"]
        self.micro_steps = meta["micro_steps"]
        self.global_samples = meta["global_samples"]
        if (load_lr_scheduler_states and self.lr_scheduler is not None
                and meta.get("lr_scheduler")):
            # re-applies the restored iteration's LR to the optimizer
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        data_state = meta.get("data_state")
        if (data_state and self.training_dataloader is not None
                and hasattr(self.training_dataloader, "load_state_dict")):
            # re-arm the loader at the checkpointed cursor and drop the
            # live iterator, so the next train_batch() pulls the
            # fast-forwarded stream
            self.training_dataloader.load_state_dict(data_state)
            self._train_iter = None

        client_state = None
        cs_path = os.path.join(ckpt_dir, CLIENT_STATE_PKL)
        if os.path.isfile(cs_path):
            with open(cs_path, "rb") as f:
                client_state = pickle.load(f)
        # a resumed job can take its preemption save before the first
        # periodic save_checkpoint sets a directory
        self._last_ckpt_dir = load_dir
        ck_dp = meta.get("dp_world_size")
        if ck_dp is not None and int(ck_dp) != self.dp_world_size:
            logger.info(f"elastic restore: checkpoint written at dp={ck_dp} "
                        f"re-padded onto dp={self.dp_world_size}")
        logger.info(f"loaded checkpoint {ckpt_dir}")
        return ckpt_dir, client_state

    def _restore_flat_state(self, opt_npz, meta, load_optimizer_states):
        """The master, the optimizer state and the error-feedback
        residuals from ``optim_states.npz`` (JAX ``engine.py:4222-4291``).
        A file written by a reduced-precision offload layout carries
        residuals under ``qres/<name>``: a load into the same layout
        keeps them as they are; any other load folds each into its value
        (and a residual of this engine's layout is then the exact
        rounding error of the value it stored)."""
        qres = {k[len("qres/"):]: opt_npz[k]
                for k in opt_npz.files if k.startswith("qres/")}
        ck_layout = meta.get("offload_state_dtype")
        sd = (self._config.zero_config.offload_state_dtype
              if self._quant is not None else None)
        field = {"master": "master", "exp_avg": "momentum",
                 "exp_avg_sq": "variance"}

        def same_layout(name):
            return (name in field and ck_layout is not None
                    and sd is not None and ck_layout.get("error_feedback")
                    and sd["error_feedback"]
                    and ck_layout.get(field[name]) == sd[field[name]]
                    and name in qres)

        def folded(name, arr):
            r = qres.get(name)
            if r is None or same_layout(name):
                return arr
            return np.asarray(arr, np.float32) + np.asarray(r, np.float32)

        values = {"master": folded("master", opt_npz["master"])}
        self.flat.scatter_master_from_unpadded(values["master"],
                                               out=self.master)
        if load_optimizer_states:
            opt = {k[len("opt/"):]: folded(k[len("opt/."):], opt_npz[k])
                   for k in opt_npz.files if k.startswith("opt/")}
            values.update((k.lstrip("."), v) for k, v in opt.items())
            self._restore_opt_state(opt)
        for name, buf in self._qres.items():
            if same_layout(name):
                res = np.asarray(qres[name], np.float32)
            elif name in values:
                # the exact rounding error of the value just stored
                val = torch.from_numpy(np.asarray(values[name], np.float32))
                res = (val - val.to(buf.dtype).float()).numpy()
            else:
                res = np.zeros(sum(self.segments.sizes), np.float32)
            self.flat.scatter_master_from_unpadded(res, out=buf)

    def _restore_opt_state(self, host):
        """Fill the optimizer state from ``{field path key: array}``
        (``.exp_avg``, ``.exp_avg_sq``, ``.step``): the flat buffers from
        their unpadded form, in place; the host step as an int."""
        for name, leaf in state_fields(self.opt_state).items():
            key = f".{name}"
            if key not in host:
                raise CheckpointError(f"checkpoint missing optimizer state "
                                      f"opt/{key}")
            if isinstance(leaf, torch.Tensor):
                self.flat.scatter_master_from_unpadded(host[key], out=leaf)
            else:
                setattr(self.opt_state, name, int(host[key]))


def _attach_grads(params, grads):
    """Make every param an autograd leaf whose ``.grad`` is preset to its
    view of the flat gradient buffer: autograd then adds into it in
    place."""
    for key, p in params.items():
        if isinstance(p, dict):
            _attach_grads(p, grads[key])
        else:
            p.requires_grad_(True)
            p.grad = grads[key]
