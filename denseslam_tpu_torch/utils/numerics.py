"""Division by (or of) a Python number with one rounding on every device.

The JAX package divides arrays by Python numbers with true division. In
PyTorch, a CUDA tensor divided by a Python number is multiplied by the
number's reciprocal, and on every device a Python number divided by a
tensor is the tensor's reciprocal times the number: two roundings each,
which move some quotients by an ulp against the reference and between the
card and the CPU. A 0-d tensor operand on the other operand's device takes
the true division.

The numbers are configuration constants (intrinsics, truncation distance,
series coefficients), so each 0-d tensor is made once per (value, dtype,
device) and kept: on the card, making it is a fill launch of its own.
"""

from __future__ import annotations

import torch

_SCALARS: dict = {}


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """x as a 0-d tensor of `like`'s dtype and device, made once."""
    key = (x, like.dtype, like.device)
    t = _SCALARS.get(key)
    if t is None:
        t = _SCALARS[key] = torch.full((), x, dtype=like.dtype,
                                       device=like.device)
    return t


def true_div(a, b) -> torch.Tensor:
    """a / b, one of them a tensor and the other a tensor or a Python
    number, rounded once."""
    if not isinstance(a, torch.Tensor):
        a = _scalar(a, b)
    elif not isinstance(b, torch.Tensor):
        b = _scalar(b, a)
    return a / b


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device. The card's
    `torch.sqrt` is; the CPU kernel is not (it differs from the IEEE result
    in the last bit on about 0.6% of inputs), so there the root is taken in
    float64 and rounded once, which is exact."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).to(torch.float32)
    return torch.sqrt(x)
