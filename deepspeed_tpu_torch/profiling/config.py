"""Profiling configs (port of ``deepspeed_tpu/profiling/config.py``): the
reference-parity ``flops_profiler`` block and the ``profiling`` block
(memory ledger, watermarks, comm ledger), with the JAX package's keys,
tristates and defaults."""

FLOPS_PROFILER = "flops_profiler"
FLOPS_PROFILER_ENABLED = "enabled"
FLOPS_PROFILER_ENABLED_DEFAULT = False
FLOPS_PROFILER_PROFILE_STEP = "profile_step"
FLOPS_PROFILER_PROFILE_STEP_DEFAULT = 1
FLOPS_PROFILER_MODULE_DEPTH = "module_depth"
FLOPS_PROFILER_MODULE_DEPTH_DEFAULT = -1
FLOPS_PROFILER_TOP_MODULES = "top_modules"
FLOPS_PROFILER_TOP_MODULES_DEFAULT = 3
FLOPS_PROFILER_DETAILED = "detailed"
FLOPS_PROFILER_DETAILED_DEFAULT = True


class DeepSpeedFlopsProfilerConfig:
    def __init__(self, param_dict):
        d = param_dict.get(FLOPS_PROFILER, {})
        self.enabled = d.get(FLOPS_PROFILER_ENABLED, FLOPS_PROFILER_ENABLED_DEFAULT)
        self.profile_step = d.get(FLOPS_PROFILER_PROFILE_STEP, FLOPS_PROFILER_PROFILE_STEP_DEFAULT)
        self.module_depth = d.get(FLOPS_PROFILER_MODULE_DEPTH, FLOPS_PROFILER_MODULE_DEPTH_DEFAULT)
        self.top_modules = d.get(FLOPS_PROFILER_TOP_MODULES, FLOPS_PROFILER_TOP_MODULES_DEFAULT)
        self.detailed = d.get(FLOPS_PROFILER_DETAILED, FLOPS_PROFILER_DETAILED_DEFAULT)

    def repr(self):
        return dict(enabled=self.enabled, profile_step=self.profile_step,
                    module_depth=self.module_depth, top_modules=self.top_modules,
                    detailed=self.detailed)


def _tristate(value, name):
    """"auto" | true | false."""
    if value in (True, False) or value == "auto":
        return value
    raise ValueError(f"profiling.{name} must be true, false or \"auto\", "
                     f"got {value!r}")


class DeepSpeedProfilingConfig:
    """Typed view of the ``profiling`` block."""

    def __init__(self, param_dict):
        from ..runtime import constants as C
        from ..runtime.config_utils import get_scalar_param

        prof = param_dict.get(C.PROFILING, {}) or {}
        self.memory_ledger = _tristate(get_scalar_param(
            prof, C.PROFILING_MEMORY_LEDGER,
            C.PROFILING_MEMORY_LEDGER_DEFAULT), C.PROFILING_MEMORY_LEDGER)
        self.memory_watermarks = _tristate(get_scalar_param(
            prof, C.PROFILING_MEMORY_WATERMARKS,
            C.PROFILING_MEMORY_WATERMARKS_DEFAULT),
            C.PROFILING_MEMORY_WATERMARKS)
        self.comm_ledger = _tristate(get_scalar_param(
            prof, C.PROFILING_COMM_LEDGER,
            C.PROFILING_COMM_LEDGER_DEFAULT), C.PROFILING_COMM_LEDGER)
        self.program_dump = _tristate(get_scalar_param(
            prof, C.PROFILING_PROGRAM_DUMP,
            C.PROFILING_PROGRAM_DUMP_DEFAULT), C.PROFILING_PROGRAM_DUMP)

    def comm_ledger_enabled(self, telemetry_enabled):
        if self.comm_ledger == "auto":
            return bool(telemetry_enabled)
        return bool(self.comm_ledger)

    def memory_ledger_enabled(self, telemetry_enabled):
        if self.memory_ledger == "auto":
            return bool(telemetry_enabled)
        return bool(self.memory_ledger)

    def program_dump_enabled(self, comm_ledger_enabled):
        """Whether each recorded phase lands under the run dir's
        ``programs/``: "auto" follows the comm ledger, whose records the
        dump writes."""
        if self.program_dump == "auto":
            return bool(comm_ledger_enabled)
        return bool(self.program_dump)

    def memory_watermarks_enabled(self, telemetry_enabled):
        # watermark output is gauges/events: without telemetry there is
        # no sink, so "true" still requires telemetry to matter
        if self.memory_watermarks == "auto":
            return bool(telemetry_enabled)
        return bool(self.memory_watermarks) and bool(telemetry_enabled)

    def __repr__(self):
        return (f"DeepSpeedProfilingConfig(memory_ledger="
                f"{self.memory_ledger!r}, memory_watermarks="
                f"{self.memory_watermarks!r}, comm_ledger="
                f"{self.comm_ledger!r}, program_dump="
                f"{self.program_dump!r})")
