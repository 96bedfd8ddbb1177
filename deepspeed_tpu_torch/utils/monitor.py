"""Training metrics monitor (TensorBoard + JSONL), port of
``deepspeed_tpu/utils/monitor.py``.

Analog of the reference engine's inline tensorboard logging
(``deepspeed/runtime/engine.py:149-150, 1014-1067``): scalar summaries of
loss / learning rate / loss scale / throughput per optimizer step, gated on
the ``tensorboard`` config section.  A JSONL event log is always written
alongside (cheap, grep-able, no reader dependency); the TensorBoard writer
is used when ``torch.utils.tensorboard`` is importable.

The monitor is a thin *consumer* of the per-step scalar flow: the engine
routes print-cadence scalars through
:meth:`~deepspeed_tpu_torch.telemetry.manager.TelemetryManager.step_metrics`,
which feeds the structured event stream / metrics registry AND this
writer — the TB/JSONL output and its config gating are unchanged, and
the canonical queryable record is the telemetry event stream.
"""

import json
import logging
import os
import time

logger = logging.getLogger(__name__)


class TrainingMonitor:
    """Writes per-step scalars; rank-0 only (reference gates on
    ``global_rank == 0``, ``engine.py:1014``)."""

    def __init__(self, enabled, output_path="", job_name="DeepSpeedJobName",
                 rank=0):
        self.enabled = bool(enabled) and rank == 0
        self._tb = None
        self._jsonl = None
        if not self.enabled:
            return
        base = os.path.join(output_path or "runs", job_name)
        os.makedirs(base, exist_ok=True)
        self._jsonl_path = os.path.join(base, "events.jsonl")
        self._jsonl = open(self._jsonl_path, "a")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=base)
        except Exception as e:  # tensorboard optional
            logger.warning(f"tensorboard writer unavailable ({e}); "
                           f"scalars go to {self._jsonl_path} only")

    def write_scalars(self, step, scalars):
        """``scalars``: {tag: float}."""
        if not self.enabled:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for tag, val in scalars.items():
                self._tb.add_scalar(tag, float(val), int(step))
            # writes happen on the (coarse) steps_per_print cadence, so
            # flush eagerly — a run exiting before SummaryWriter's timed
            # flush would otherwise lose its tail scalars
            self._tb.flush()

    def flush(self):
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
