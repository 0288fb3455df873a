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

import functools
from typing import Optional

import numpy as np
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


def recip(x: float) -> float:
    """1 / x rounded to float32, from x rounded to float32: the factor by
    which jitted XLA:CPU multiplies where the JAX code divides by the
    constant x (its simplifier's `A / c => A * (1 / c)`; eager JAX divides,
    `true_div`)."""
    return float(torch.tensor(1.0, dtype=torch.float32)
                 / torch.tensor(x, dtype=torch.float32))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device. The card's
    `torch.sqrt` is; the CPU kernel is not (it differs from the IEEE result
    in the last bit on about 0.6% of inputs), so there the root is taken in
    float64 and rounded once, which is exact."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).to(torch.float32)
    return torch.sqrt(x)


# a float64 that lies on a float32 midpoint has these low 29 bits
_LOW29 = (1 << 29) - 1
_MID29 = 1 << 28


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for float32 tensors, rounded once (CUDA's `__fmaf_rn`, and
    the FMAs jitted XLA:CPU contracts a multiply and an add into), alike on
    every device. In float64 the product is exact (24 + 24 bits) and the
    sum's rounding error is recovered exactly (two-sum); the sum is then
    rounded to odd (moved to its odd neighbour toward the error where it is
    inexact and even), which with 29 spare bits makes the final rounding
    to float32 correct: plain float64 arithmetic would round twice and
    part from the FMA on values near a float32 midpoint. On the CPU the
    sum is rounded directly and only values whose float64 sum lies on a
    float32 midpoint take that path (the same bits in fewer launches; on
    the card the test would wait for the device)."""
    if a.device.type != "cpu":
        a, b, c = torch.broadcast_tensors(a.double(), b.double(), c.double())
        return _round_sum(a * b, c)
    # in numpy, about two thirds of torch's time on the CPU: the exact
    # product plus c in one float64 buffer, rounded, and the midpoint test
    # on the sums' bits
    s = np.asarray(np.multiply(a.numpy(), b.numpy(), dtype=np.float64))
    cn = c.numpy()
    s = np.add(s, cn, out=s) if s.shape == cn.shape else s + cn
    shape = s.shape
    mid = (s.view(np.int64) & _LOW29) == _MID29
    r = torch.from_numpy(s.astype(np.float32))
    if mid.any():
        # only the sums on a midpoint, taken again exactly
        flat = torch.from_numpy(mid.reshape(-1).nonzero()[0])
        at = torch.unravel_index(flat, shape)
        pa, pb, pc = (x.expand(shape)[at].double() for x in (a, b, c))
        r.view(-1)[flat] = _round_sum(pa * pb, pc)
    return r


def _round_sum(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """p + c rounded once to float32, for float64 p (an exact product of
    two float32 numbers) and c (a float32 number held in float64): `fma`'s
    two-sum and rounding to odd."""
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, _scalar(float("inf"), s),
                         _scalar(float("-inf"), s))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


_CHAIN_BLOCK = 256


def fma_chain(terms: torch.Tensor, init: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """The float32 accumulator of a chain of FMAs along dim 0 from `init`
    (float32, default 0): acc = fma(x_k, y_k, acc) for k in order, given
    terms[k] = x_k * y_k exact in float64. Each step is one launch: the
    term plus the accumulator added in float64 and stored rounded to
    float32 (into the next row of `hist`; on the CPU numpy's add, the
    same arithmetic at a fraction of torch's cost a call). That equals the
    FMA unless the float64 sum lies on a float32 midpoint without being
    exact. After each block of steps one test of the block's sums and
    two-sum errors finds the first such step; it is taken again with
    `_round_sum` and the chain goes on from there."""
    steps = terms.shape[0]
    hist = torch.empty((steps + 1,) + terms.shape[1:], dtype=torch.float32,
                       device=terms.device)
    if init is None:
        hist[0].zero_()
    else:
        hist[0].copy_(init)
    if terms.device.type == "cpu":
        # rows as 1-d arrays (numpy's add writes no 0-d `out`)
        tv = list(terms.numpy().reshape(steps, -1))
        hv = list(hist.numpy().reshape(steps + 1, -1))
        add = functools.partial(np.add, casting="same_kind")
    else:
        tv, hv = terms.unbind(0), hist.unbind(0)
        add = torch.add
    start = 0
    while start < steps:
        stop = min(start + _CHAIN_BLOCK, steps)
        for k in range(start, stop):
            add(tv[k], hv[k], out=hv[k + 1])
        t = terms[start:stop]
        a = hist[start:stop].double()
        s = t + a
        mid = (s.view(torch.int64) & _LOW29) == _MID29
        if bool(mid.any()):
            # the two-sum errors of the sums on a midpoint only
            ts, at, st = t[mid], a[mid], s[mid]
            bb = st - ts
            inexact = ((ts - (st - bb)) + (at - bb)) != 0
            steps_bad = mid.nonzero()[inexact, 0]
            if steps_bad.numel():
                k = start + int(steps_bad.min())
                hist[k + 1].copy_(_round_sum(terms[k], a[k - start]))
                start = k + 1
                continue
        start = stop
    return hist[steps]


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


def fma_dot_exact(a: torch.Tensor, b: torch.Tensor, dim: int = -1
                  ) -> torch.Tensor:
    """`fma_dot` with every step a true FMA: the float32 sum of a * b
    along `dim` (broadcast) from 0, acc = fma(a_k, b_k, acc), one `fma` a
    step. For the short chains of the Gauss-Newton update's plain
    version."""
    a, b = torch.broadcast_tensors(a, b)
    dim = dim % a.dim()
    acc = torch.zeros(a.shape[:dim] + a.shape[dim + 1:], dtype=torch.float32,
                      device=a.device)
    for ak, bk in zip(a.unbind(dim), b.unbind(dim)):
        acc = fma(ak, bk, acc)
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


# The normal equations of the VO's Gauss-Newton step, S = [A | b] with
# A = (J w)^T J and b = (J w)^T r over the 4N rows of J (ops/ransac.py
# `_gn_refine`), in the order jitted XLA:CPU sums them on the host that
# made the golden (tests/golden/*.npz meta `host`: an AVX-512 Xeon, 8
# threads, jax 0.9). Read from `tests/_torch_golden.py --dump` of the
# golden's `process_sequence` and held bit for bit by
# tests/test_torch_gn_normal.py; the port copies it as a fixed rule and
# never reads the host it runs on:
#   * J w is one rounded multiply a term (a fusion of its own);
#   * A is a dot that runs in Eigen (no kernel module in the dump): the 4N
#     terms in panels of 4096 (the last one shorter), each panel in 4
#     lanes (term q of the panel in lane q % 4), a lane a chain of FMAs
#     from 0, the lanes added (l0 + l1) + (l2 + l3), the panels added in
#     order;
#   * b of a batch (the hypotheses, vmapped), and of one system whose
#     vector r holds 16 KB or more (4N >= 4096: the flagship's refit), is
#     XLA's row-major GEMV emitter (`row_major_gemv_F32_8_8_6_*`): the
#     first 8 floor(4N / 8) terms in 8 lanes (term q in lane q % 8), each
#     a chain of FMAs from 0 (`vfmadd231ps`), the lanes halved (l + 4,
#     then l + 2, then l + 1), plus a chain of FMAs from 0 over the
#     4N % 8 terms left;
#   * b of one system with a smaller r (4N < 4096: the refit of 256 or
#     512 features) is fused with the product J w and the residuals into
#     a loop fusion (XLA:CPU fuses a matrix-vector dot whose vector is
#     under 16 KB), which XLA emits as a scalar loop over the 4N terms
#     (the residuals' concatenation branches, so LLVM does not vectorize
#     it): J w rounded, then one chain of FMAs from 0 in term order.
GN_PANEL = 4096
GN_A_LANES = 4
GN_B_LANES = 8
GN_FUSED_B_TERMS = 4096     # 4N below this, one system: the fused order


def gn_fused_b(lead: tuple, n: int) -> bool:
    """Whether b of J (lead..., n, 4, 6) takes the fused order above."""
    return len(lead) == 0 and 4 * n < GN_FUSED_B_TERMS


def gn_normal(J: torch.Tensor, r: torch.Tensor, w: torch.Tensor
              ) -> torch.Tensor:
    """S = [A | b], (..., 6, 7), of J (..., N, 4, 6), r (..., N, 4) and
    w (..., N), float32, in the order above: kernel GN's plain version
    (csrc/gn_normal.cu). The lanes, panels and hypotheses are tensor
    dimensions and the chains run in step, one `fma_chain` for A and b
    together."""
    lead = J.shape[:-3]
    k = 4 * J.shape[-3]
    fused = gn_fused_b(lead, J.shape[-3])
    x = (J * w[..., None, None]).reshape(lead + (k, 6)).double()
    y = J.reshape(lead + (k, 6)).double()
    rr = r.reshape(lead + (k,)).double()
    # A: (steps, ..., panels * lanes * 36) products, zero past the last term
    plen = min(k, GN_PANEL)
    panels = -(-k // plen)
    xa = torch.nn.functional.pad(x, (0, 0, 0, panels * plen - k))
    ya = torch.nn.functional.pad(y, (0, 0, 0, panels * plen - k))
    shape = lead + (panels, plen // GN_A_LANES, GN_A_LANES, 6)
    pa = xa.reshape(shape)[..., :, None] * ya.reshape(shape)[..., None, :]
    pa = pa.movedim(-4, 0).flatten(-4)
    # b: the GEMV's lanes, then the rest's chain as one more lane; fused,
    # one chain
    lanes = 1 if fused else GN_B_LANES
    kl = k - k % lanes
    pb = (x[..., :kl, :] * rr[..., :kl, None]).reshape(
        lead + (kl // lanes, lanes * 6)).movedim(-2, 0)
    pe = (x[..., kl:, :] * rr[..., kl:, None]).movedim(-2, 0)
    steps = max(pa.shape[0], pb.shape[0], pe.shape[0])
    na, nb = pa.shape[-1], pb.shape[-1]
    terms = torch.zeros((steps,) + lead + (na + nb + 6,),
                        dtype=torch.float64, device=J.device)
    terms[:pa.shape[0], ..., :na] = pa
    terms[:pb.shape[0], ..., na:na + nb] = pb
    terms[:pe.shape[0], ..., na + nb:] = pe
    acc = fma_chain(terms)
    la = acc[..., :na].reshape(lead + (panels, GN_A_LANES, 6, 6))
    pan = (la[..., 0, :, :] + la[..., 1, :, :]) + (la[..., 2, :, :]
                                                   + la[..., 3, :, :])
    A = pan[..., 0, :, :]
    for p in range(1, panels):
        A = A + pan[..., p, :, :]
    lb = acc[..., na:na + nb].reshape(lead + (lanes, 6))
    if fused:
        b = lb[..., 0, :]
    else:
        lb = lb[..., :4, :] + lb[..., 4:, :]
        lb = lb[..., :2, :] + lb[..., 2:, :]
        b = (lb[..., 0, :] + lb[..., 1, :]) + acc[..., na + nb:]
    return torch.cat([A, b[..., None]], dim=-1)


# sin and cos as jitted XLA:CPU takes them: a call to the C library's
# sinf / cosf (`tests/_torch_golden.py --dump`: `call sinf`), which on the
# golden's host is glibc's FMA variant (x86-64, AVX2 + FMA): the argument
# in double, reduced by n = round(x 2 / pi) below 120, and a polynomial in
# double from the table `__sincosf_table`, rounded once to float32. Its
# constants and operation order were read from the host's libm.so.6
# (`objdump -d` of the resolved `sinf`, the table from .rodata); glibc
# differs from the correctly rounded sin on about 2% of float32 inputs,
# and from CUDA's `sinf` too. Here each double FMA is a double multiply
# and add, which moves the double result by at most a few of its ulps:
# the float32 result then differs only where glibc's double lies within
# that of a float32 midpoint (a chance of about 2^-27 a value).
_SINCOSF = (
    # sign[4], hpi_inv, hpi, c0, c1, s1, c2, s2, c3, s3, c4
    (1.0, -1.0, -1.0, 1.0, float.fromhex("0x1.45f306dc9c883p+23"),
     float.fromhex("0x1.921fb54442d18p+0"), 1.0,
     float.fromhex("-0x1.ffffffd0c621cp-2"),
     float.fromhex("-0x1.555545995a603p-3"),
     float.fromhex("0x1.55553e1068f19p-5"),
     float.fromhex("0x1.1107605230bc4p-7"),
     float.fromhex("-0x1.6c087e89a359dp-10"),
     float.fromhex("-0x1.994eb3774cf24p-13"),
     float.fromhex("0x1.99343027bf8c3p-16")),
    (1.0, -1.0, -1.0, 1.0, float.fromhex("0x1.45f306dc9c883p+23"),
     float.fromhex("0x1.921fb54442d18p+0"), -1.0,
     float.fromhex("0x1.ffffffd0c621cp-2"),
     float.fromhex("-0x1.555545995a603p-3"),
     float.fromhex("-0x1.55553e1068f19p-5"),
     float.fromhex("0x1.1107605230bc4p-7"),
     float.fromhex("0x1.6c087e89a359dp-10"),
     float.fromhex("-0x1.994eb3774cf24p-13"),
     float.fromhex("-0x1.99343027bf8c3p-16")),
)


def _sincosf_poly(x, x2, p, odd):
    """glibc's `sinf_poly`: the sin series of x (odd false) or the cos
    series (odd true), in double, p the table's columns as tensors."""
    _, _, _, _, _, _, c0, c1, s1, c2, s2, c3, s3, c4 = p
    x3 = x2 * x
    s = x3 * s1 + x
    sp = (x2 * s3 + s2) * (x3 * x2) + s
    x4 = x2 * x2
    cp = (x2 * c4 + c3) * (x2 * x4) + (x4 * c2 + (x2 * c1 + c0))
    return torch.where(odd, cp, sp)


def sincosf(y: torch.Tensor):
    """(sin, cos) of float32 y as jitted XLA:CPU computes them (glibc's
    sinf and cosf), for |y| < 120 (the Gauss-Newton's angles are under
    1): one argument reduction, then both series."""
    x = y.double()
    top = (y.view(torch.int32) >> 20) & 0x7FF
    cols = constant([v for t in _SINCOSF for v in t], torch.float64,
                    y.device).view(2, 14).unbind(1)
    t0 = [c[0] for c in cols]
    # |y| < 0.75: the series about 0 with table 0 (tiny |y|: y and 1)
    x2 = x * x
    yes = torch.ones_like(top, dtype=torch.bool)
    near = (_sincosf_poly(x, x2, t0, ~yes), _sincosf_poly(x, x2, t0, yes))
    tiny = top <= 0x397
    near = (torch.where(tiny, x, near[0]),
            torch.where(tiny, _scalar(1.0, x), near[1]))
    # else: n = round(2 y / pi), r = y - n pi / 2, the table n & 2 picks
    n = (((x * t0[4]).to(torch.int32) + 0x800000) >> 24)
    r = x - n.double() * t0[5]
    sel = (n & 2) != 0
    p = [torch.where(sel, c[1], c[0]) for c in cols]
    sign = torch.stack(cols[:4])[:, 0][n & 3]
    r2 = r * r
    far = []
    for cos in (False, True):
        odd = ((n & 1) != 0) ^ cos
        far.append(_sincosf_poly(torch.where(odd, r, r * sign), r2, p, odd))
    small = top <= 0x3F3
    return tuple(torch.where(small, a, b).to(torch.float32)
                 for a, b in zip(near, far))

