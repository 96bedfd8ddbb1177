"""Wall-clock and throughput timers (port of
``deepspeed_tpu/utils/timer.py``, itself the reference's
``deepspeed/utils/timer.py``).

- :class:`SynchronizedWallClockTimer` — named timers whose
  ``start``/``stop`` fence the card with ``torch.cuda.synchronize`` when
  asked (``sync=True``); ``sync=False`` reads the host clock alone.
- :class:`ThroughputTimer` — samples/s over windows of
  ``steps_per_output`` steps, after ``start_step`` warm-up steps, ended
  by the caller's own host sync.
"""

import logging
import time

import torch

from .logging import log_dist

__all__ = ["SynchronizedWallClockTimer", "ThroughputTimer", "device_fence",
           "log_dist"]

logger = logging.getLogger(__name__)


def device_fence(device=None):
    """Wait for the work queued on ``device`` (every stream of it):
    ``torch.cuda.synchronize`` on a CUDA device, nothing on the CPU,
    whose work is done when it returns.  ``device=None`` fences the
    current CUDA device where there is one."""
    if device is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SynchronizedWallClockTimer:
    """Named timers with device fencing, matching the reference API.
    ``device`` is the device a ``sync=True`` start or stop fences."""

    class Timer:
        def __init__(self, name, device=None):
            self.name_ = name
            self.device = device
            self.elapsed_ = 0.0
            self.started_ = False
            self.start_time = time.time()

        def start(self, sync=True):
            assert not self.started_, f"{self.name_} timer has already been started"
            if sync:
                device_fence(self.device)
            self.start_time = time.time()
            self.started_ = True

        def stop(self, sync=True):
            assert self.started_, "timer is not started"
            if sync:
                device_fence(self.device)
            self.elapsed_ += time.time() - self.start_time
            self.started_ = False

        def reset(self):
            self.elapsed_ = 0.0
            self.started_ = False

        def elapsed(self, reset=True):
            started_ = self.started_
            if self.started_:
                self.stop()
            elapsed_ = self.elapsed_
            if reset:
                self.reset()
            if started_:
                self.start()
            return elapsed_

        def mean(self, count):
            return self.elapsed(reset=False) / max(count, 1)

    def __init__(self, device=None):
        self.device = device
        self.timers = {}

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = self.Timer(name, self.device)
        return self.timers[name]

    @staticmethod
    def memory_usage():
        """Allocation stats summed over ALL local cards (card 0 alone
        understates a multi-card host's footprint): bytes allocated now,
        the peak since the last reset and the cards' total memory
        (:func:`~deepspeed_tpu_torch.profiling.memory.device_memory_summary`,
        the one implementation)."""
        from ..profiling import memory as mem

        summary = mem.device_memory_summary()
        if not summary["reporting"]:
            return "mem stats unavailable (no CUDA device)"
        return mem.format_memory_summary(summary)

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=False,
            ranks=None):
        """Log named timers (ms, divided by ``normalizer``); ``ranks``
        filters to those ranks (None = all) and ``memory_breakdown``
        appends the cross-card memory summary."""
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed_time = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                string += f" | {name}: {elapsed_time:.2f}"
        if memory_breakdown:
            string += " | " + self.memory_usage()
        log_dist(string, ranks=ranks, logger=logger)


class ThroughputTimer:
    """Samples/s with warm-up skipping (reference ``timer.py:97-163``).

    Durations are measured over whole windows: the time between two
    window boundaries over the steps in between (a per-step host time of
    an asynchronous step would only measure the enqueue).  Where the
    reference synchronizes the device at each boundary, this timer adds
    no sync: its caller stops it right after a host sync of its own (the
    training engine, after the print cadence's loss fetch, with
    ``steps_per_output`` the print cadence), so a window ends where the
    device has run its steps; the first window also holds the tail of
    the warm-up steps' queued work."""

    def __init__(self, batch_size, num_workers, start_step=2,
                 steps_per_output=50, monitor_memory=False, logging_fn=None):
        self.start_time = 0
        self.end_time = 0
        self.started = False
        self.batch_size = max(batch_size, 1)
        self.num_workers = num_workers
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0
        self.counted_steps = 0
        self._window_anchor = None
        self._window_anchor_step = 0
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or logger.info
        self.initialized = False

    def update_epoch_count(self):
        self.epoch_count += 1
        self.micro_step_count = 0

    def start(self):
        self.initialized = True
        self.started = True
        if self.global_step_count >= self.start_step:
            if self._window_anchor is None:
                # the first measured window opens here
                self._window_anchor = time.time()
                self._window_anchor_step = self.global_step_count
            self.start_time = time.time()

    def stop(self, report_speed=True):
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        self.global_step_count += 1
        if self.start_time > 0:
            if (self.global_step_count % self.steps_per_output == 0
                    and self._window_anchor is not None):
                now = time.time()
                window_steps = self.global_step_count - self._window_anchor_step
                window_time = now - self._window_anchor
                self.total_elapsed_time += window_time
                self.counted_steps += window_steps
                self._window_anchor = now
                self._window_anchor_step = self.global_step_count
                if report_speed and window_steps > 0 and window_time > 0:
                    avg = self.avg_samples_per_sec()
                    # before any counted window the running average is
                    # 0.0, and the field is left out
                    avg_part = (f"RunningAvgSamplesPerSec={avg:.2f}, "
                                if avg > 0 else "")
                    self.logging(
                        f"{self.__class__.__name__}: epoch={self.epoch_count}/"
                        f"micro_step={self.micro_step_count}/"
                        f"global_step={self.global_step_count}, "
                        f"{avg_part}"
                        f"CurrSamplesPerSec={self.batch_size * self.num_workers * window_steps / window_time:.2f}"
                    )

    def avg_samples_per_sec(self):
        if self.counted_steps > 0 and self.total_elapsed_time > 0:
            samples_per_step = self.batch_size * self.num_workers
            avg_time_per_step = self.total_elapsed_time / self.counted_steps
            return samples_per_step / avg_time_per_step
        # no counted window yet: 0.0, not the reference's float("-inf")
        return 0.0
