"""Applications of the SA power model (the paper's CNN evaluation, the
quickstart)."""
from __future__ import annotations

import torch


def check_device(device, what: str) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present (the port never falls back to the CPU by itself).
    ``what`` names the entry point in the message."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"CUDA is not available: {what} runs on the card by default; "
            f"pass device='cpu' to run it on the CPU")
    return device
