"""Profiling (port of ``deepspeed_tpu/profiling/``): the flops profiler
(:mod:`.flops_profiler`, B1–B6 counted as their plain versions count),
the per-entry-point memory ledger and watermarks (:mod:`.memory`), the
per-phase collective ledger and the per-rank latency exchange
(:mod:`.comm`), the step's wall breakdown and latency ring
(:mod:`.step_profiler`), the card's peak table and MFU
(:mod:`.utilization`) and the ``flops_profiler`` and ``profiling``
config blocks (:mod:`.config`).

Still to be ported, each queued in ROADMAP A12 in this order: the JAX
package's receipts derived from compiled HLO, which need a torch design
of their own — ``overlap.py`` (the ledger entries' ``overlap``
summary, ``analyze_hlo``, ``parse_hlo_transfers``,
``transfer_summary``), ``verify.py`` and its ``ProgramDumper``
(``profiling.program_dump``), ``attribution.py``, ``doctor.py`` and
``sharding.py``; then ``capacity.py`` (AOT ``memory_analysis``)."""

from .comm import (CommLedger, collective_summary, fleet_skew,
                   predicted_wire_bytes, publish_rank_latency,
                   read_fleet_latencies, step_program_weights)
from .config import DeepSpeedFlopsProfilerConfig, DeepSpeedProfilingConfig
from .flops_profiler import FlopsProfiler, count_fn_flops, get_model_profile
from .memory import (HostBufferRegistry, MemoryLedger, device_memory_summary,
                     see_memory_usage)
from .step_profiler import (model_scope_breakdown, timed_loop, timed_scan,
                            wall_breakdown)
from .utilization import (DEFAULT_PEAK_TFLOPS, PEAK_TFLOPS, chip_peak_tflops,
                          chip_specs, model_flops_utilization)

__all__ = ["CommLedger", "collective_summary", "predicted_wire_bytes",
           "publish_rank_latency", "read_fleet_latencies", "fleet_skew",
           "DeepSpeedFlopsProfilerConfig", "DeepSpeedProfilingConfig",
           "FlopsProfiler", "count_fn_flops", "get_model_profile",
           "wall_breakdown", "model_scope_breakdown", "timed_loop",
           "timed_scan", "MemoryLedger", "HostBufferRegistry",
           "device_memory_summary", "see_memory_usage", "PEAK_TFLOPS",
           "DEFAULT_PEAK_TFLOPS", "chip_peak_tflops", "chip_specs",
           "model_flops_utilization", "step_program_weights"]
