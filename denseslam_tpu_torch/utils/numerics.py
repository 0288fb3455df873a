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


def constant(x, dtype: torch.dtype, device) -> torch.Tensor:
    """The numbers x as a 1-d tensor of `dtype` on `device`, made once
    from fills on the device (a copy from the host would wait for the
    card)."""
    key = (tuple(x), dtype, torch.device(device))
    t = _SCALARS.get(key)
    if t is None:
        like = torch.empty((), dtype=dtype, device=device)
        t = _SCALARS[key] = torch.stack([_scalar(v, like) for v in x])
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


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for float32 tensors, rounded once (CUDA's `__fmaf_rn`, and
    the FMAs jitted XLA:CPU contracts a multiply and an add into), alike on
    every device. In float64 the product is exact (24 + 24 bits) and the
    sum's rounding error is recovered exactly (two-sum); the sum is then
    rounded to odd (moved to its odd neighbour toward the error where it is
    inexact and even), which with 29 spare bits makes the final rounding
    to float32 correct: plain float64 arithmetic would round twice and
    part from the FMA on values near a float32 midpoint."""
    a, b, c = torch.broadcast_tensors(a.double(), b.double(), c.double())
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, _scalar(float("inf"), s),
                         _scalar(float("-inf"), s))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def fma_dot(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The float32 sum of a * b along `dim` (broadcast), as jitted XLA:CPU
    reduces a product (a row reduce of x * x, a small batched matmul): from
    0, one FMA per term in order, acc = a_k * b_k + acc. Each step adds
    the exact float64 product and rounds to float32 in one launch, the
    same arithmetic on every device. That rounds twice, so it parts from
    a true FMA (`fma`) only where the float64 sum lands exactly on a
    float32 midpoint without being exact, which needs a product within
    2^-29 of half a float32 ulp of the sum."""
    p = a.double() * b
    dim = dim % p.dim()
    acc = torch.empty(p.shape[:dim] + p.shape[dim + 1:], dtype=torch.float32,
                      device=p.device)
    torch.add(p.select(dim, 0), 0.0, out=acc)           # 0 + a_0 b_0
    for k in range(1, p.shape[dim]):
        torch.add(p.select(dim, k), acc, out=acc)
    return acc


def fma_twice(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c for a float32 tensor and float32 tensors or constants b,
    c, as `fma_dot` rounds a step: the exact float64 product plus c,
    rounded to float64 and then to float32, in four launches (`fma`
    takes about fifteen); forward-mode AD goes through it. Alike on every
    device; it parts from a true FMA only where the float64 sum lands
    exactly on a float32 midpoint without being exact (a chance of about
    2^-29 a value)."""
    return (a.double() * b + c).to(torch.float32)


def tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The sum of `x` along `dim` in x's dtype by a halving tree:
    zero-padded to a power of two, then the upper half added onto the
    lower half until one term is left, one launch a level. Elementwise
    adds only, so every device rounds it alike, in about log2(n) launches
    (a library's reduction or matmul sums in an order of its own, which
    differs between the card and the CPU)."""
    dim = dim % x.dim()
    n = x.shape[dim]
    m = 1 << max(n - 1, 0).bit_length()
    if m > n:
        pad = [0, 0] * (x.dim() - 1 - dim) + [0, m - n]
        x = torch.nn.functional.pad(x, pad)
    while m > 1:
        m //= 2
        x = x.narrow(dim, 0, m) + x.narrow(dim, m, m)
    return x.squeeze(dim)


def sum_seq(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The float32 sum of `x` along `dim` from 0, left to right, one add a
    term: the order of jitted XLA:CPU's reduce of a short row (the ZSSD
    patch means)."""
    dim = dim % x.dim()
    acc = torch.zeros(x.shape[:dim] + x.shape[dim + 1:], dtype=x.dtype,
                      device=x.device)
    for k in range(x.shape[dim]):
        acc = acc + x.select(dim, k)
    return acc
