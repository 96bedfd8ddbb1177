"""Profiling (port of ``deepspeed_tpu/profiling/``): the flops profiler
(:mod:`.flops_profiler`, B1–B6 counted as their plain versions count),
the per-entry-point memory ledger and watermarks (:mod:`.memory`), the
per-phase collective ledger and the per-rank latency exchange
(:mod:`.comm`), the overlap model (:mod:`.overlap`: the JAX summary of
which wire seconds a step pays, priced from what the step dispatches,
the HLO parser not ported), the step-time attribution (:mod:`.attribution`,
a copy), the program dumps (:mod:`.verify`: ``profiling.program_dump``'s
``programs/`` sidecars; the DSP6xx verifier raises), the offline doctor
(:mod:`.doctor`, ``python -m deepspeed_tpu_torch.profiling.doctor
<run_dir>``), the step's wall breakdown and latency ring
(:mod:`.step_profiler`), the card's peak table and MFU
(:mod:`.utilization`) and the ``flops_profiler`` and ``profiling``
config blocks (:mod:`.config`).

Still to be ported, each queued in ROADMAP A12 in this order: the DSP6xx
program verifier (step 2, step 6's dslint), ``sharding.py`` (step 4) and
``capacity.py`` (step 5, AOT ``memory_analysis``)."""

from .comm import (CommLedger, collective_summary, fleet_skew,
                   predicted_wire_bytes, publish_rank_latency,
                   read_fleet_latencies, step_program_weights)
from .attribution import reconcile, step_budget, straggler_explanation
from .config import DeepSpeedFlopsProfilerConfig, DeepSpeedProfilingConfig
from .doctor import doctor_run_dir
from .flops_profiler import FlopsProfiler, count_fn_flops, get_model_profile
from .memory import (HostBufferRegistry, MemoryLedger, device_memory_summary,
                     see_memory_usage)
from .step_profiler import (model_scope_breakdown, timed_loop, timed_scan,
                            wall_breakdown)
from .overlap import DispatchPricer, analyze_dispatch
from .utilization import (DEFAULT_PEAK_TFLOPS, PEAK_TFLOPS, chip_peak_tflops,
                          chip_specs, model_flops_utilization)
from .verify import ProgramDumper, load_run_programs

__all__ = ["CommLedger", "collective_summary", "predicted_wire_bytes",
           "publish_rank_latency", "read_fleet_latencies", "fleet_skew",
           "DeepSpeedFlopsProfilerConfig", "DeepSpeedProfilingConfig",
           "FlopsProfiler", "count_fn_flops", "get_model_profile",
           "wall_breakdown", "model_scope_breakdown", "timed_loop",
           "timed_scan", "MemoryLedger", "HostBufferRegistry",
           "device_memory_summary", "see_memory_usage", "PEAK_TFLOPS",
           "DEFAULT_PEAK_TFLOPS", "chip_peak_tflops", "chip_specs",
           "model_flops_utilization", "step_program_weights",
           "DispatchPricer", "analyze_dispatch", "step_budget", "reconcile",
           "straggler_explanation", "ProgramDumper", "load_run_programs",
           "doctor_run_dir"]
