"""Where the port's entry points run (port-only module)."""

import torch


def resolve_device(device, who):
    """``None`` means the card: ``cuda``, or an error naming ``who`` when
    there is none.  Nothing drops to the CPU on its own; pass ``"cpu"``
    to ask for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} runs on CUDA by default and no CUDA device is "
                f"available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
