"""Device selection for the port's public constructors."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; without one it raises rather than carry
    on on the CPU. Pass `device="cpu"` to run the plain versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
