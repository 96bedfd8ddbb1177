"""Where the port's entry points run (port-only module)."""

import torch
import torch.distributed as dist

from .distributed import get_local_rank


def resolve_device(device, who):
    """``None`` means the card: ``cuda`` (``cuda:LOCAL_RANK`` under a
    process group, one card a rank), or an error naming ``who`` when
    there is none.  Nothing drops to the CPU on its own; pass ``"cpu"``
    to ask for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} runs on CUDA by default and no CUDA device is "
                f"available; pass device='cpu' to run on the CPU")
        if dist.is_initialized():
            return torch.device("cuda", get_local_rank())
        return torch.device("cuda")
    return torch.device(device)
