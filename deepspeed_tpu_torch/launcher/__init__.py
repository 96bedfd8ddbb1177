"""Launcher package: hostfile-driven job start, one process per card
(port of ``deepspeed_tpu/launcher/``).  Stdlib-only, as in the JAX
package: ``python -m deepspeed_tpu_torch.launcher.runner`` starts
without touching the card, apart from counting the cards when there is
no hostfile."""

from .runner import (decode_world_info, encode_world_info, fetch_hostfile,
                     filter_resources)

__all__ = ["decode_world_info", "encode_world_info", "fetch_hostfile",
           "filter_resources"]
