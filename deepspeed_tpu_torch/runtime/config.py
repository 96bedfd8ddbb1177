"""DeepSpeed config, the subset the training slice reads (port of
``deepspeed_tpu/runtime/config.py``).

One JSON file or dict, parsed once: the batch triple
``train_batch_size = micro_batch × gradient_accumulation_steps ×
data_parallel_size`` solved and checked as in the JAX package
(``:406-453``); ``optimizer``, ``scheduler``, ``bf16``, ``fp16``,
``zero_optimization``, ``gradient_clipping``, ``steps_per_print``,
``wall_clock_breakdown`` and ``sparse_attention`` (one of the five layout
modes, resolved with its defaults by :func:`get_sparse_attention` into
the kwargs ``build_sparsity_config`` takes).  Unknown keys warn with a "did you mean" hint
and raise under ``"strict_config": true`` (the JAX package checks them in
``tools/dslint/schema.py``).  Blocks the port does not implement yet warn
when set, naming their ROADMAP item; ``fp16.enabled`` raises, since the
loss scaler is ROADMAP A4.
"""

import logging

from . import constants as C
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
        self._initialize_params(param_dict)
        self._configure_train_batch_size()
        self._do_error_check()

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

        self.fp16_enabled = bool(get_scalar_param(
            param_dict.get(C.FP16, {}), C.FP16_ENABLED,
            C.FP16_ENABLED_DEFAULT))
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
                "has no analog of; use bf16")
        if self.fp16_enabled:
            raise NotImplementedError(
                "fp16 training needs the dynamic loss scaler, which the "
                "PyTorch port does not have yet (ROADMAP A4); use bf16")
