"""Device choice for the port's entry points: the card unless the caller
asks for something else."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU.  Raises where a CUDA device is asked for (or
    defaulted to) and none is present: the entry points never drop to the
    CPU on their own; pass ``device="cpu"`` for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
