"""DeepSpeed config, the subset the training slice reads (port of
``deepspeed_tpu/runtime/config.py``).

One JSON file or dict, parsed once: the batch triple
``train_batch_size = micro_batch × gradient_accumulation_steps ×
data_parallel_size`` solved and checked as in the JAX package
(``:406-453``); ``optimizer``, ``scheduler``, ``bf16``, ``fp16``,
``zero_optimization``, ``gradient_clipping``, ``steps_per_print``,
``wall_clock_breakdown``, ``sparse_attention`` (one of the five layout
modes, resolved with its defaults by :func:`get_sparse_attention` into
the kwargs ``build_sparsity_config`` takes), ``activation_checkpointing``
(``DeepSpeedActivationCheckpointingConfig``), ``progressive_layer_drop``
(:func:`get_progressive_layer_drop`), ``checkpoint``
(:class:`~deepspeed_tpu_torch.checkpoint.config.DeepSpeedCheckpointConfig`)
``resilience``
(:class:`~deepspeed_tpu_torch.resilience.config.DeepSpeedResilienceConfig`),
``telemetry``
(:class:`~deepspeed_tpu_torch.telemetry.config.DeepSpeedTelemetryConfig`),
``tensorboard`` (the monitor's ``enabled``, ``output_path``,
``job_name``) and ``sparse_gradients``.  An enabled ``elasticity`` block
derives ``train_batch_size``, the micro-batch and the accumulation
steps from the data-parallel world size before the batch triple is
solved (JAX ``:287-319``, :mod:`deepspeed_tpu_torch.elasticity`).  A ``ring_attention`` block is known and
logs that it has no effect: a model's ``attn_impl="ring"`` and the
mesh's ``seq`` axis select the ring.  The engines read ``mesh`` through
:func:`get_mesh_config` and the pipeline engine reads ``pipeline``
through :func:`get_pipeline_config` (applying it to its module) before
this parse, which needs the mesh's size.
``fp16`` gives ``loss_scale``, ``initial_dynamic_scale`` and
``dynamic_loss_scale_args`` as the JAX config does (``:40-97``).
Unknown keys warn with a "did you mean" hint and raise under
``"strict_config": true`` (the JAX package checks them in
``tools/dslint/schema.py``).  Blocks the port does not implement yet warn
when set, naming their ROADMAP item.
"""

import logging

from ..checkpoint.config import DeepSpeedCheckpointConfig
from ..elasticity import (compute_elastic_config, elasticity_enabled,
                          ensure_immutable_elastic_config)
from ..elasticity import constants as EC
from ..elasticity.config import ElasticityConfigError
from ..profiling.config import (DeepSpeedFlopsProfilerConfig,
                                DeepSpeedProfilingConfig)
from ..resilience.config import DeepSpeedResilienceConfig
from ..telemetry.config import DeepSpeedTelemetryConfig
from . import constants as C
from .activation_checkpointing.config import \
    DeepSpeedActivationCheckpointingConfig
from .config_utils import (did_you_mean, get_scalar_param,
                           load_config_json)
from .zero.config import DeepSpeedZeroConfig

logger = logging.getLogger(__name__)


class DeepSpeedConfigError(Exception):
    pass


def _section_enabled(value):
    """Whether a block asks for its feature: a dict is on unless its
    ``enabled`` is false; a bare bool is itself."""
    if isinstance(value, dict):
        return bool(value.get("enabled", True))
    return bool(value)


def config_issues(param_dict):
    """Messages for unknown keys (top level and inside known blocks) and
    for set blocks the port does not implement."""
    issues = []
    for key, value in param_dict.items():
        if key not in C.KNOWN_KEYS:
            issues.append(f"unknown config key '{key}'"
                          f"{did_you_mean(key, C.KNOWN_KEYS)}")
            continue
        sub_keys = C.SECTION_KEYS.get(key)
        if sub_keys and isinstance(value, dict):
            for sub in value:
                if sub not in sub_keys:
                    issues.append(f"unknown key '{sub}' in config section "
                                  f"'{key}'{did_you_mean(sub, sub_keys)}")
        if key in C.UNPORTED_SECTIONS and _section_enabled(value):
            issues.append(f"config section '{key}' is set but the PyTorch "
                          f"port does not implement it yet (ROADMAP "
                          f"{C.UNPORTED_SECTIONS[key]}); it has no effect")
    return issues


def get_mesh_config(json_file_or_dict):
    """The ``mesh`` block's axis sizes (JAX ``config.py:222-230``):
    ``data`` defaults to -1 (the whole world), the others to 1."""
    param_dict = (json_file_or_dict if isinstance(json_file_or_dict, dict)
                  else load_config_json(json_file_or_dict))
    mesh = dict(param_dict.get(C.MESH, {}))
    mesh.setdefault(C.MESH_DATA, -1)
    mesh.setdefault(C.MESH_MODEL, 1)
    mesh.setdefault(C.MESH_PIPE, 1)
    mesh.setdefault(C.MESH_SEQ, 1)
    mesh.setdefault(C.MESH_EXPERT, 1)
    return mesh


def get_pipeline_config(param_dict):
    """The ``pipeline`` block with the JAX package's defaults
    (``config.py:199-211``): ``stages``, ``partition`` ("best"),
    ``seed_layers`` and ``activation_checkpoint_interval``; any other key
    it sets (``interleave``) passes through."""
    config = {
        C.PIPELINE_STAGES: C.PIPELINE_STAGES_DEFAULT,
        C.PIPELINE_PARTITION: C.PIPELINE_PARTITION_DEFAULT,
        C.PIPELINE_SEED_LAYERS: C.PIPELINE_SEED_LAYERS_DEFAULT,
        C.PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL:
            C.PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL_DEFAULT,
    }
    config.update(param_dict.get(C.PIPELINE, {}))
    return config


def get_progressive_layer_drop(param_dict):
    pld = param_dict.get(C.PROGRESSIVE_LAYER_DROP, {})
    return {
        "enabled": get_scalar_param(pld, C.PLD_ENABLED,
                                    C.PLD_ENABLED_DEFAULT),
        "theta": get_scalar_param(pld, C.PLD_THETA, C.PLD_THETA_DEFAULT),
        "gamma": get_scalar_param(pld, C.PLD_GAMMA, C.PLD_GAMMA_DEFAULT),
    }


def get_fp16_enabled(param_dict):
    if C.FP16 in param_dict:
        return get_scalar_param(param_dict[C.FP16], C.FP16_ENABLED,
                                C.FP16_ENABLED_DEFAULT)
    return C.FP16_ENABLED_DEFAULT


def get_loss_scale(param_dict):
    """``fp16.loss_scale``: 0 (dynamic) or a static scale."""
    if get_fp16_enabled(param_dict):
        return get_scalar_param(param_dict[C.FP16], C.FP16_LOSS_SCALE,
                                C.FP16_LOSS_SCALE_DEFAULT)
    return C.FP16_LOSS_SCALE_DEFAULT


def get_initial_dynamic_scale(param_dict):
    """2 ** ``fp16.initial_scale_power``."""
    power = C.FP16_INITIAL_SCALE_POWER_DEFAULT
    if get_fp16_enabled(param_dict):
        power = get_scalar_param(param_dict[C.FP16],
                                 C.FP16_INITIAL_SCALE_POWER, power)
    return 2 ** power


def get_dynamic_loss_scale_args(param_dict):
    """The dynamic scaler's settings when the fp16 block sets any of
    them (then every one, defaults filled in), else None: the JAX
    package's rule, under which the scaler falls back to a window of
    1000, min scale 1 and no hysteresis (``delayed_shift`` 1)."""
    if not get_fp16_enabled(param_dict):
        return None
    fp16 = param_dict[C.FP16]
    props = (C.FP16_INITIAL_SCALE_POWER, C.FP16_LOSS_SCALE_WINDOW,
             C.FP16_MIN_LOSS_SCALE, C.FP16_HYSTERESIS)
    if not any(prop in fp16 for prop in props):
        return None
    return {
        "init_scale": 2 ** get_scalar_param(
            fp16, C.FP16_INITIAL_SCALE_POWER,
            C.FP16_INITIAL_SCALE_POWER_DEFAULT),
        "scale_window": get_scalar_param(fp16, C.FP16_LOSS_SCALE_WINDOW,
                                         C.FP16_LOSS_SCALE_WINDOW_DEFAULT),
        "delayed_shift": get_scalar_param(fp16, C.FP16_HYSTERESIS,
                                          C.FP16_HYSTERESIS_DEFAULT),
        "min_scale": get_scalar_param(fp16, C.FP16_MIN_LOSS_SCALE,
                                      C.FP16_MIN_LOSS_SCALE_DEFAULT),
    }


def get_sparse_attention(param_dict):
    """The ``sparse_attention`` block as a kwargs dict for its mode, every
    key the mode reads filled with its default; None without the block
    (port of ``get_sparse_attention``, ``config.py:124-194``)."""
    if C.SPARSE_ATTENTION not in param_dict:
        return None
    sparsity = param_dict[C.SPARSE_ATTENTION]

    def read(*names):
        return {getattr(C, f"SPARSE_{n}"): get_scalar_param(
            sparsity, getattr(C, f"SPARSE_{n}"),
            getattr(C, f"SPARSE_{n}_DEFAULT")) for n in names}

    mode = get_scalar_param(sparsity, C.SPARSE_MODE, C.SPARSE_MODE_DEFAULT)
    common = {C.SPARSE_MODE: mode,
              **read("BLOCK", "DIFFERENT_LAYOUT_PER_HEAD")}
    if mode == C.SPARSE_DENSE_MODE:
        return common
    if mode == C.SPARSE_FIXED_MODE:
        extra = read("NUM_LOCAL_BLOCKS", "NUM_GLOBAL_BLOCKS",
                     "ATTENTION_TYPE", "HORIZONTAL_GLOBAL_ATTENTION",
                     "NUM_DIFFERENT_GLOBAL_PATTERNS")
    elif mode == C.SPARSE_VARIABLE_MODE:
        extra = read("NUM_RANDOM_BLOCKS", "LOCAL_WINDOW_BLOCKS",
                     "GLOBAL_BLOCK_INDICES", "GLOBAL_BLOCK_END_INDICES",
                     "ATTENTION_TYPE", "HORIZONTAL_GLOBAL_ATTENTION")
    elif mode == C.SPARSE_BIGBIRD_MODE:
        extra = read("NUM_RANDOM_BLOCKS", "NUM_SLIDING_WINDOW_BLOCKS",
                     "NUM_GLOBAL_BLOCKS")
    elif mode == C.SPARSE_BSLONGFORMER_MODE:
        extra = read("NUM_SLIDING_WINDOW_BLOCKS", "GLOBAL_BLOCK_INDICES",
                     "GLOBAL_BLOCK_END_INDICES")
    else:
        raise NotImplementedError(
            f"Given sparsity mode, {mode!r}, has not been implemented yet!")
    common.update(extra)
    return common


class DeepSpeedConfig:
    """The parsed config.  ``world_size`` is the data-parallel size for
    the batch solver (1 unless given)."""

    def __init__(self, json_file_or_dict, world_size=1):
        if isinstance(json_file_or_dict, dict):
            self._param_dict = json_file_or_dict
        else:
            self._param_dict = load_config_json(json_file_or_dict)
        param_dict = self._param_dict
        self.strict_config = bool(param_dict.get(C.STRICT_CONFIG,
                                                 C.STRICT_CONFIG_DEFAULT))
        issues = config_issues(param_dict)
        for issue in issues:
            logger.warning("DeepSpeedConfig: %s", issue)
        if self.strict_config and issues:
            raise DeepSpeedConfigError(
                "strict_config: rejected configuration: "
                + "; ".join(issues))
        self.world_size = world_size
        self.elasticity_enabled = elasticity_enabled(param_dict)
        if self.elasticity_enabled:
            self._param_dict = param_dict = self._elastic_batch(param_dict)
        self._initialize_params(param_dict)
        self._configure_train_batch_size()
        self._do_error_check()

    def _elastic_batch(self, param_dict):
        """A copy of ``param_dict`` whose batch triple the elastic
        schedule sets for this world size (JAX ``config.py:287-319``):
        the schedule's global batch, the largest listed micro-batch that
        divides this world's share, and the accumulation steps between
        them.  A config that also sets a batch key raises, unless the
        block sets ``ignore_non_elastic_batch_info``."""
        logger.info("DeepSpeed elasticity support enabled")
        final_batch, valid, micro = compute_elastic_config(
            ds_config=param_dict, target_deepspeed_version="0",
            world_size=self.world_size)
        elastic = param_dict[EC.ELASTICITY]
        ensure_immutable_elastic_config(runtime_elastic_config_dict=elastic)
        if not elastic.get(EC.IGNORE_NON_ELASTIC_BATCH_INFO,
                           EC.IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT):
            batch_keys = (C.TRAIN_BATCH_SIZE,
                          C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
                          C.GRADIENT_ACCUMULATION_STEPS)
            if any(k in param_dict for k in batch_keys):
                raise ElasticityConfigError(
                    "One or more batch related parameters were found in "
                    "your ds_config. These parameters *will not be used* "
                    "since elastic training is enabled, which takes "
                    "control of these parameters. To suppress this error "
                    f"set '{EC.IGNORE_NON_ELASTIC_BATCH_INFO}':true in "
                    "your elasticity config.")
        logger.info(f"[Elasticity] valid device counts: {valid}")
        return {**param_dict,
                C.TRAIN_BATCH_SIZE: final_batch,
                C.TRAIN_MICRO_BATCH_SIZE_PER_GPU: micro,
                C.GRADIENT_ACCUMULATION_STEPS:
                    final_batch // (micro * self.world_size)}

    def _initialize_params(self, param_dict):
        self.train_batch_size = get_scalar_param(
            param_dict, C.TRAIN_BATCH_SIZE, C.TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = get_scalar_param(
            param_dict, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.gradient_accumulation_steps = get_scalar_param(
            param_dict, C.GRADIENT_ACCUMULATION_STEPS,
            C.GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        self.steps_per_print = get_scalar_param(
            param_dict, C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT)
        self.wall_clock_breakdown = get_scalar_param(
            param_dict, C.WALL_CLOCK_BREAKDOWN,
            C.WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.seed = get_scalar_param(param_dict, C.SEED, C.SEED_DEFAULT)

        self.zero_config = DeepSpeedZeroConfig(param_dict)
        self.zero_optimization_stage = self.zero_config.stage
        self.zero_enabled = self.zero_optimization_stage > 0

        self.fp16_enabled = bool(get_fp16_enabled(param_dict))
        self.loss_scale = get_loss_scale(param_dict)
        self.initial_dynamic_scale = get_initial_dynamic_scale(param_dict)
        self.dynamic_loss_scale_args = get_dynamic_loss_scale_args(
            param_dict)
        self.bf16_enabled = bool(get_scalar_param(
            param_dict.get(C.BF16, {}), C.BF16_ENABLED,
            C.BF16_ENABLED_DEFAULT))
        self.gradient_clipping = get_scalar_param(
            param_dict, C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT)

        optimizer = param_dict.get(C.OPTIMIZER, {})
        self.optimizer_name = optimizer.get(C.TYPE, C.OPTIMIZER_TYPE_DEFAULT)
        if (self.optimizer_name is not None
                and self.optimizer_name.lower() in C.DEEPSPEED_OPTIMIZERS):
            self.optimizer_name = self.optimizer_name.lower()
        self.optimizer_params = (optimizer.get(C.OPTIMIZER_PARAMS)
                                 if self.optimizer_name is not None
                                 else None)
        self.zero_allow_untested_optimizer = get_scalar_param(
            param_dict, C.ZERO_ALLOW_UNTESTED_OPTIMIZER,
            C.ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT)
        scheduler = param_dict.get(C.SCHEDULER, {})
        self.scheduler_name = scheduler.get(C.TYPE, C.SCHEDULER_TYPE_DEFAULT)
        self.scheduler_params = (scheduler.get(C.SCHEDULER_PARAMS)
                                 if self.scheduler_name is not None
                                 else None)

        self.sparse_attention = get_sparse_attention(param_dict)
        if "ring_attention" in param_dict:
            logger.info("DeepSpeedConfig: the 'ring_attention' block has no "
                        "effect; a model's attn_impl='ring' and the mesh's "
                        "seq axis select the ring")
        self.activation_checkpointing_config = \
            DeepSpeedActivationCheckpointingConfig(param_dict)
        self.pld_params = get_progressive_layer_drop(param_dict)
        self.pld_enabled = self.pld_params["enabled"]
        self.checkpoint_config = DeepSpeedCheckpointConfig(param_dict)
        self.resilience_config = DeepSpeedResilienceConfig(param_dict)
        self.telemetry_config = DeepSpeedTelemetryConfig(param_dict)
        self.flops_profiler_config = DeepSpeedFlopsProfilerConfig(param_dict)
        self.profiling_config = DeepSpeedProfilingConfig(param_dict)
        tb = param_dict.get(C.TENSORBOARD, {}) or {}
        self.tensorboard_enabled = bool(get_scalar_param(
            tb, C.TENSORBOARD_ENABLED, C.TENSORBOARD_ENABLED_DEFAULT))
        self.tensorboard_output_path = get_scalar_param(
            tb, C.TENSORBOARD_OUTPUT_PATH, C.TENSORBOARD_OUTPUT_PATH_DEFAULT)
        self.tensorboard_job_name = get_scalar_param(
            tb, C.TENSORBOARD_JOB_NAME, C.TENSORBOARD_JOB_NAME_DEFAULT)
        self.sparse_gradients_enabled = bool(get_scalar_param(
            param_dict, C.SPARSE_GRADIENTS, C.SPARSE_GRADIENTS_DEFAULT))

    def _set_batch_related_parameters(self):
        """Solve the batch triple from any subset of it."""
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        if (train_batch is not None and micro_batch is not None
                and grad_acc is not None):
            return
        if train_batch is not None and micro_batch is not None:
            self.gradient_accumulation_steps = \
                train_batch // micro_batch // self.world_size
        elif train_batch is not None and grad_acc is not None:
            self.train_micro_batch_size_per_gpu = \
                train_batch // self.world_size // grad_acc
        elif micro_batch is not None and grad_acc is not None:
            self.train_batch_size = micro_batch * grad_acc * self.world_size
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = \
                train_batch // self.world_size
        elif micro_batch is not None:
            self.train_batch_size = micro_batch * self.world_size
            self.gradient_accumulation_steps = 1
        else:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu "
                "needs to be provided")

    def _configure_train_batch_size(self):
        self._set_batch_related_parameters()
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        assert train_batch > 0, (
            f"Train batch size: {train_batch} has to be greater than 0")
        assert micro_batch > 0, (
            f"Micro batch size per gpu: {micro_batch} has to be greater "
            f"than 0")
        assert grad_acc > 0, (
            f"Gradient accumulation steps: {grad_acc} has to be greater "
            f"than 0")
        assert train_batch == micro_batch * grad_acc * self.world_size, (
            f"Check batch related parameters. train_batch_size is not equal"
            f" to micro_batch_per_gpu * gradient_acc_step * world_size"
            f" {train_batch} != {micro_batch} * {grad_acc} * "
            f"{self.world_size}")

    def _do_error_check(self):
        if self.zero_config.cpu_offload:
            assert self.zero_optimization_stage >= \
                C.ZERO_OPTIMIZATION_GRADIENTS, (
                    "DeepSpeedConfig: cpu-offload supported ZeRO stage is "
                    f"{C.ZERO_OPTIMIZATION_GRADIENTS}")
        assert not (self.fp16_enabled and self.bf16_enabled), (
            "fp16 and bf16 modes are mutually exclusive")
        amp = self._param_dict.get(C.AMP, C.AMP_ENABLED_DEFAULT)
        if (amp if isinstance(amp, bool)
                else get_scalar_param(amp, C.AMP_ENABLED,
                                      C.AMP_ENABLED_DEFAULT)):
            raise DeepSpeedConfigError(
                "amp is a torch/apex mixed-precision mode the JAX package "
                "has no analog of; use bf16 or fp16")
