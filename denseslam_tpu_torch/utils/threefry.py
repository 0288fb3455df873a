"""JAX's counter-based PRNG in torch integer ops: the Threefry-2x32 hash
and the jax.random functions built on it, as JAX computes them with
`jax_threefry_partitionable` set (its default): keys, split, fold_in,
32-bit random bits, uniform, normal and randint.

The port draws from torch generators; this module reproduces the JAX
package's draws where a check needs the reference's own data on the card,
as chip_smoke.py's `vo_drift` phase does for the drift golden of
tests/test_vo_numerics.py (its noise `fold_in(PRNGKey(0), i)`, the
frontend's RANSAC keys). Keys, bits, uniform samples and integers equal
jax.random's bit for bit; `normal` evaluates XLA's erf_inv polynomial in
torch, whose log1p and unfused multiply-adds round differently from
XLA's, so its samples agree within a few float32 ulps.

Keys are (2,) int64 tensors holding the two uint32 words; every uint32
operation is done in int64 and masked to 32 bits.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the count words x1, x2 under
    the key words k1, k2 (uint32 values in int64)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M
    x2 = (x2 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M
    return x1, x2


def _words(key: torch.Tensor):
    return key[0], key[1]


def prng_key(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) for 0 <= seed < 2^32."""
    if not 0 <= seed <= _M:
        raise ValueError("seed must fit 32 unsigned bits")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in(key, data): the key hashed with the count
    (0, data)."""
    k1, k2 = _words(key)
    zero = torch.zeros(1, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(k1, k2, zero, zero + (data & _M))
    return torch.cat([y1, y2])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num): (num, 2) keys, the hash of the counts
    (0, j)."""
    k1, k2 = _words(key)
    j = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(j), j)
    return torch.stack([y1, y2], dim=1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits for each element of `shape` (uint32 values in
    int64): the hash of the element's 64-bit flat index, its two words
    xored."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    k1, k2 = _words(key)
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & _M)
    return (y1 ^ y2).reshape(tuple(shape))


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform in float32: the top 23 bits as the mantissa of
    a float in [1, 2), less 1, scaled to [minval, maxval) in float32."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


# XLA's float32 erf_inv (M. Giles' single-precision approximation)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv: w = -log1p(-x^2); a degree-8 polynomial in
    w - 2.5 below 5, in sqrt(w) - 3 above; +-inf at +-1."""
    def const(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, const(_ERFINV_LT5[0]), const(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, const(a), const(b)) + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(x.dtype).max, p * x)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """jax.random.normal in float32: sqrt(2) erf_inv(u) of a uniform u in
    (-1, 1) (its low end the float32 after -1), erf_inv as XLA computes
    it (erfinv above; torch's log1p and XLA's multiply-adds round
    differently, so the two agree within a few ulps)."""
    one = torch.tensor(-1.0, dtype=torch.float32)
    lo = float(torch.nextafter(one, torch.zeros_like(one)))
    u = uniform(key, shape, lo, 1.0)
    return torch.tensor(math.sqrt(2.0), dtype=torch.float32,
                        device=key.device) * erfinv(u)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """jax.random.randint(key, shape, minval, maxval) of int32 as int64:
    two 32-bit draws reduced modulo the span in uint32 arithmetic, where
    JAX's multiplier 2^32 mod span wraps (to 0 for a span of 2^16 or
    more, so that the second draw alone decides)."""
    if not -2 ** 31 <= minval < maxval <= 2 ** 31 - 1:
        raise ValueError("randint takes an int32 range minval < maxval")
    k = split(key)
    higher, lower = random_bits(k[0], shape), random_bits(k[1], shape)
    span = (maxval - minval) & _M
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M) % span      # wraps: 0 for spans >= 2^16
    off = (((higher % span) * mult) & _M) + (lower % span)
    off = (off & _M) % span
    return minval + off
