"""SGM path aggregation: kernel 2 (csrc/sgm.cu) and its plain PyTorch
version.

Replaces denseslam_tpu/ops/sgm_pallas.py (`_v_kernel` / `_h_kernel`) and
serves both `sgm_backend` values; the recurrence is the one the JAX
package's "xla" backend runs with `lax.scan` (ops/stereo.py
`sgm_aggregate`). The backends differ only in how the four directional
aggregates are summed:

  "pallas": ((v_fwd + v_bwd) + h_fwd) + h_bwd   (accumulated in place)
  "xla":    (tb + bt) + (lr + rl)

Both sum orders are reproduced exactly; they agree with each other bit
for bit only on integer-valued f32 costs.
"""

from __future__ import annotations

import torch

from .. import kernels

_DTYPES = (torch.float32, torch.bfloat16)


def _step(prev, cur, p1, p2):
    """One recurrence step on an (S, D) slab; the same op order as the JAX
    `_step`, each op rounding in the cost dtype."""
    prev_min = prev.amin(dim=-1, keepdim=True)
    shift_p = torch.cat([prev[:, :1], prev[:, :-1]], dim=1)
    shift_n = torch.cat([prev[:, 1:], prev[:, -1:]], dim=1)
    best = torch.minimum(
        torch.minimum(prev, shift_p + p1),
        torch.minimum(shift_n + p1, prev_min + p2),
    )
    return cur + best - prev_min


def path_plain(cost: torch.Tensor, axis: int, reverse: bool,
               p1: float, p2: float) -> torch.Tensor:
    """One path direction from a zero carry. axis 0 walks H (vertical
    paths), axis 1 walks W (horizontal paths)."""
    vol = cost if axis == 0 else cost.transpose(0, 1)       # (T, S, D)
    p1t = torch.full((), p1, dtype=cost.dtype, device=cost.device)
    p2t = torch.full((), p2, dtype=cost.dtype, device=cost.device)
    out = torch.empty_like(vol)
    prev = torch.zeros_like(vol[0])
    order = range(vol.shape[0] - 1, -1, -1) if reverse else range(vol.shape[0])
    for t in order:
        prev = _step(prev, vol[t], p1t, p2t)
        out[t] = prev
    return out if axis == 0 else out.transpose(0, 1)


def sgm_aggregate_plain(cost: torch.Tensor, p1: float, p2: float,
                        backend: str) -> torch.Tensor:
    """Plain PyTorch version of kernel 2's four launches."""
    tb = path_plain(cost, 0, False, p1, p2)
    bt = path_plain(cost, 0, True, p1, p2)
    lr = path_plain(cost, 1, False, p1, p2)
    rl = path_plain(cost, 1, True, p1, p2)
    if backend == "pallas":
        return ((tb + bt) + lr) + rl
    return (tb + bt) + (lr + rl)


def _launch_path(cost, out, axis, reverse, p1, p2, acc=None, extra=None):
    h, w, d = cost.shape
    if axis == 0:      # vertical: one scanline per column
        lines, steps, line_stride, step_stride = w, h, d, w * d
    else:              # horizontal: one scanline per row
        lines, steps, line_stride, step_stride = h, w, w * d, d
    kernels.launch(
        "sgm_path", cost.device, cost, acc, extra, out, lines, steps,
        line_stride, step_stride, int(reverse), d, p1, p2,
        int(cost.dtype == torch.bfloat16))


def sgm_aggregate(cost: torch.Tensor, p1: float, p2: float,
                  backend: str = "xla") -> torch.Tensor:
    """4-path SGM aggregation of an (H, W, D) volume in its own dtype.
    CPU tensors take `sgm_aggregate_plain`; CUDA tensors launch
    csrc/sgm.cu four times (or raise)."""
    if backend not in ("xla", "pallas"):
        raise ValueError(f"unknown sgm_backend {backend!r}")
    if cost.device.type == "cpu":
        return sgm_aggregate_plain(cost, p1, p2, backend)
    h, w, d = cost.shape
    if cost.dtype not in _DTYPES:
        raise ValueError(f"cost dtype {cost.dtype} not in {_DTYPES}")
    kernels.check_tensor(cost, "cost", cost.dtype, (h, w, d))
    if d % 32 or d // 32 not in (1, 2, 4, 8):
        raise ValueError(f"kernel needs D in (32, 64, 128, 256), got {d}")
    vert = torch.empty_like(cost)
    _launch_path(cost, vert, 0, False, p1, p2)
    _launch_path(cost, vert, 0, True, p1, p2, acc=vert)
    if backend == "pallas":
        _launch_path(cost, vert, 1, False, p1, p2, acc=vert)
        _launch_path(cost, vert, 1, True, p1, p2, acc=vert)
        return vert
    horiz = torch.empty_like(cost)
    _launch_path(cost, horiz, 1, False, p1, p2)
    _launch_path(cost, horiz, 1, True, p1, p2, acc=horiz, extra=vert)
    return horiz
