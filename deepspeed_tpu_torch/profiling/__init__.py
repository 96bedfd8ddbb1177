"""Profiling (port of ``deepspeed_tpu/profiling/``): so far the step-latency
ring the resilience watchdog reads; the rest is ROADMAP A16."""
