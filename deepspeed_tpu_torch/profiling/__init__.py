"""Profiling (port of ``deepspeed_tpu/profiling/``): the step-latency
ring the resilience watchdog reads and the per-rank latency exchange
behind ``resilience.straggler_factor`` (:mod:`.comm`); the rest is
ROADMAP A12/A16."""
