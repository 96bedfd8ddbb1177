"""Async fault-tolerant checkpoint subsystem (port of
``deepspeed_tpu/checkpoint/``; the two packages write and read the same
files).

Three layers:

- :mod:`.snapshot` — one blocking device->host gather producing an
  immutable :class:`CheckpointSnapshot`;
- :mod:`.writer` — the atomic commit protocol (``<tag>.tmp/`` + fsync +
  manifest checksums + ``os.replace``) and :func:`verify_checkpoint`;
- :mod:`.manager` — :class:`CheckpointManager`: background writer threads,
  retention (``keep_last_n`` / ``keep_every_n_steps``), retry/backoff, and
  the SIGTERM preemption drain.

``engine.save_checkpoint`` / ``load_checkpoint`` are thin wrappers over
these; the ``"checkpoint": {...}`` config block selects the behavior.
"""

from .config import DeepSpeedCheckpointConfig  # noqa: F401
from .constants import (CLIENT_STATE_PKL, LATEST_FILE, MANIFEST_JSON,  # noqa: F401
                        META_JSON, MODEL_STATES_NPZ, OPTIM_STATES_NPZ,
                        TMP_SUFFIX)
from .manager import CheckpointManager, drain_inflight  # noqa: F401
from .snapshot import (CheckpointSnapshot, capture_engine_snapshot,  # noqa: F401
                       load_model_states)
from .writer import (CheckpointCorruptionError, CheckpointError,  # noqa: F401
                     read_latest, read_manifest, recover_tag,
                     verify_checkpoint, write_checkpoint, write_latest)
