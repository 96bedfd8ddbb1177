"""The framework logger and rank-filtered logging (port of
``deepspeed_tpu/utils/logging.py``, itself the reference's
``deepspeed/utils/logging.py:7-56``).  The rank is the
``torch.distributed`` rank (0 without a process group)."""

import logging
import sys
from typing import Iterable, Optional

_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"


class LoggerFactory:
    @staticmethod
    def create_logger(name: str = "DeepSpeedTPUTorch",
                      level=logging.INFO) -> logging.Logger:
        if name is None:
            raise ValueError("name for logger cannot be None")
        formatter = logging.Formatter(_FORMAT)
        logger_ = logging.getLogger(name)
        logger_.setLevel(level)
        logger_.propagate = False
        if not logger_.handlers:
            ch = logging.StreamHandler(stream=sys.stdout)
            ch.setLevel(level)
            ch.setFormatter(formatter)
            logger_.addHandler(ch)
        return logger_


logger = LoggerFactory.create_logger()
_FRAMEWORK_LOGGER = logger


def _rank() -> int:
    from .distributed import get_rank

    return get_rank()


def log_dist(message: str, ranks: Optional[Iterable[int]] = None,
             level=logging.INFO, logger: Optional[logging.Logger] = None
             ) -> None:
    """Log ``message`` only on the listed ranks (``[-1]`` or None: all),
    on the framework logger or on ``logger`` (a module's own, as the
    wall-clock timers log on theirs)."""
    my_rank = _rank()
    ranks = list(ranks) if ranks is not None else []
    if not ranks or -1 in ranks or my_rank in ranks:
        target = logger if logger is not None else _FRAMEWORK_LOGGER
        target.log(level, f"[Rank {my_rank}] {message}")
