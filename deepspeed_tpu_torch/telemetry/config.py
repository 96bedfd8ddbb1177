"""``"telemetry"`` config block (port of
``deepspeed_tpu/telemetry/config.py``).

Parsed by :class:`~deepspeed_tpu_torch.runtime.config.DeepSpeedConfig`
and by the serving engine; the key constants live in
``runtime/constants.py``, whose ``SECTION_KEYS`` table flags a
misspelled key ("did you mean 'events'?") at engine construction.
"""

import os

from ..runtime import constants as C
from ..runtime.config_utils import get_scalar_param


class DeepSpeedTelemetryConfig:
    """Typed view of the ``telemetry`` subsection (all keys optional)."""

    def __init__(self, param_dict):
        tel = param_dict.get(C.TELEMETRY, {}) or {}
        self.enabled = bool(get_scalar_param(
            tel, C.TELEMETRY_ENABLED, C.TELEMETRY_ENABLED_DEFAULT))
        run_dir = get_scalar_param(
            tel, C.TELEMETRY_RUN_DIR, C.TELEMETRY_RUN_DIR_DEFAULT)
        if not run_dir:
            # one run dir for every rank of a job without each training
            # script naming it
            run_dir = os.environ.get("DS_TELEMETRY_DIR", "")
        self.run_dir = str(run_dir) if run_dir else os.path.join(
            "runs", "telemetry")
        self.events = bool(get_scalar_param(
            tel, C.TELEMETRY_EVENTS, C.TELEMETRY_EVENTS_DEFAULT))
        self.trace = bool(get_scalar_param(
            tel, C.TELEMETRY_TRACE, C.TELEMETRY_TRACE_DEFAULT))
        self.trace_max_events = int(get_scalar_param(
            tel, C.TELEMETRY_TRACE_MAX_EVENTS,
            C.TELEMETRY_TRACE_MAX_EVENTS_DEFAULT))
        if self.trace_max_events <= 0:
            raise ValueError("telemetry.trace_max_events must be > 0")
        self.device_trace_secs = float(get_scalar_param(
            tel, C.TELEMETRY_DEVICE_TRACE_SECS,
            C.TELEMETRY_DEVICE_TRACE_SECS_DEFAULT))
        if self.device_trace_secs <= 0:
            raise ValueError(
                "telemetry.device_trace_secs must be > 0 (it bounds how "
                "long an on-demand device trace can run)")
        trigger = get_scalar_param(
            tel, C.TELEMETRY_DEVICE_TRACE_TRIGGER,
            C.TELEMETRY_DEVICE_TRACE_TRIGGER_DEFAULT)
        self.device_trace_trigger = str(trigger) if trigger else None

    def __repr__(self):
        return (f"DeepSpeedTelemetryConfig(enabled={self.enabled}, "
                f"run_dir={self.run_dir!r}, events={self.events}, "
                f"trace={self.trace})")
