"""SGM path aggregation and its winner-take-all tail: kernels 2
(csrc/sgm.cu) and 4 (csrc/sgm_final.cu), each with its plain PyTorch
version.

Kernel 2 replaces denseslam_tpu/ops/sgm_pallas.py (`_v_kernel` /
`_h_kernel`) and serves both `sgm_backend` values; the recurrence is the
one the JAX package's "xla" backend runs with `lax.scan` (ops/stereo.py
`sgm_aggregate`). The backends differ only in how the four directional
aggregates are summed:

  "pallas": ((v_fwd + v_bwd) + h_fwd) + h_bwd   (accumulated in place)
  "xla":    (tb + bt) + (lr + rl)

Both sum orders are reproduced exactly; they agree with each other bit
for bit only on integer-valued f32 costs.

Kernel 4 replaces the fused SGM tail probes (scripts/probes/
exp_fused_sgm.py and exp_fused_loop.py `make_kernel`): the last direction
(right to left), the sum in the backend's order and the per-pixel maps of
`wta_maps`, without writing the summed volume. `sgm_wta` is the card's
SGM + WTA: kernel 2 three times (down, up, left to right), then kernel 4.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import kernels

_DTYPES = (torch.float32, torch.bfloat16)
_BACKENDS = ("xla", "pallas")
_BIG = 1e4          # the invalid-cost marker of ops/stereo.py


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


def _check_volume(cost: torch.Tensor, backend: str) -> None:
    if backend not in _BACKENDS:
        raise ValueError(f"unknown sgm_backend {backend!r}")
    if cost.device.type == "cpu":
        return
    if cost.dtype not in _DTYPES:
        raise ValueError(f"cost dtype {cost.dtype} not in {_DTYPES}")
    kernels.check_tensor(cost, "cost", cost.dtype, cost.shape)
    d = cost.shape[-1]
    if d % 32 or d // 32 not in (1, 2, 4, 8):
        raise ValueError(f"kernel needs D in (32, 64, 128, 256), got {d}")


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


def _three_paths(cost: torch.Tensor, p1: float, p2: float, backend: str
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Down, up and left to right, summed so far as the backend's order
    allows: ("pallas") acc = (tb + bt) + lr, extra = None; ("xla")
    acc = lr, extra = tb + bt. Kernel 2 on the card (three launches), the
    plain paths on the CPU."""
    if cost.device.type == "cpu":
        vert = path_plain(cost, 0, False, p1, p2) + path_plain(cost, 0, True,
                                                               p1, p2)
        lr = path_plain(cost, 1, False, p1, p2)
        return (vert + lr, None) if backend == "pallas" else (lr, vert)
    vert = torch.empty_like(cost)
    _launch_path(cost, vert, 0, False, p1, p2)
    _launch_path(cost, vert, 0, True, p1, p2, acc=vert)
    if backend == "pallas":
        _launch_path(cost, vert, 1, False, p1, p2, acc=vert)
        return vert, None
    lr = torch.empty_like(cost)
    _launch_path(cost, lr, 1, False, p1, p2)
    return lr, vert


def sgm_aggregate(cost: torch.Tensor, p1: float, p2: float,
                  backend: str = "xla") -> torch.Tensor:
    """4-path SGM aggregation of an (H, W, D) volume in its own dtype.
    CPU tensors take `sgm_aggregate_plain`; CUDA tensors launch
    csrc/sgm.cu four times (or raise)."""
    _check_volume(cost, backend)
    if cost.device.type == "cpu":
        return sgm_aggregate_plain(cost, p1, p2, backend)
    acc, extra = _three_paths(cost, p1, p2, backend)
    _launch_path(cost, acc, 1, True, p1, p2, acc=acc, extra=extra)
    return acc


# ---------------------------------------------------------------------------
# Winner take all
# ---------------------------------------------------------------------------

class WtaMaps(NamedTuple):
    """Per-pixel maps of a summed (H, W, D) volume, all (H, W)."""
    best: torch.Tensor                # i32 first argmin over D
    cmin: torch.Tensor                # f32 the minimum
    c0: torch.Tensor                  # f32 cost at best - 1 (0 at the edge)
    c2: torch.Tensor                  # f32 cost at best + 1 (0 at the edge)
    best_r: torch.Tensor              # i32 right-view argmin
    c_at: Optional[torch.Tensor]      # f32 raw cost at best (uniqueness gate)
    second: Optional[torch.Tensor]    # f32 min raw cost with |d - best| > 2


def _pick(cost: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor):
    """cost[..., idx] as f32 where ok, else 0."""
    d = cost.shape[-1]
    g = torch.gather(cost, 2, idx.clamp(0, d - 1).long()[..., None])[..., 0]
    return torch.where(ok, g.to(torch.float32),
                       torch.zeros((), device=cost.device))


def _right_argmin(cost: torch.Tensor) -> torch.Tensor:
    """argmin_d cost_L(x + d, d) per right-view pixel, first index on ties,
    0 where no sheared value is below the invalid marker — the JAX
    version's running strict-< argmin over D column shifts, read as a
    strided view of the sheared volume."""
    h, w, d = cost.shape
    big = torch.full((), _BIG, dtype=cost.dtype, device=cost.device)
    padded = torch.cat([cost, big.expand(h, d, d)], dim=1).contiguous()
    sheared = padded.as_strided((h, w, d), ((w + d) * d, d, d + 1))
    idx = torch.argmin(sheared, dim=-1).to(torch.int32)
    val = torch.gather(sheared, 2, idx.long()[..., None])[..., 0]
    return torch.where(val < big, idx, torch.zeros_like(idx))


def wta_maps(cost: torch.Tensor, raw: Optional[torch.Tensor] = None
             ) -> WtaMaps:
    """The maps denseslam_tpu/ops/stereo.py `disparity_from_cost` derives
    from a summed volume, in plain PyTorch; with `raw` also the uniqueness
    gate's terms on the raw volume."""
    d = cost.shape[-1]
    best = torch.argmin(cost, dim=-1).to(torch.int32)
    cmin = cost.amin(dim=-1).to(torch.float32)
    c0 = _pick(cost, best - 1, best > 0)
    c2 = _pick(cost, best + 1, best < d - 1)
    best_r = _right_argmin(cost)
    c_at = second = None
    if raw is not None:
        c_at = _pick(raw, best, torch.ones_like(best, dtype=torch.bool))
        lane = torch.arange(d, dtype=torch.int32, device=cost.device)
        far = (lane - best[..., None]).abs() > 2
        big = torch.full((), _BIG, dtype=raw.dtype, device=cost.device)
        second = torch.where(far, raw, big).amin(dim=-1).to(torch.float32)
    return WtaMaps(best, cmin, c0, c2, best_r, c_at, second)


def sgm_final_plain(cost: torch.Tensor, acc: torch.Tensor,
                    extra: Optional[torch.Tensor], p1: float, p2: float,
                    backend: str, unique: bool = True) -> WtaMaps:
    """Plain PyTorch version of kernel 4: the right-to-left path, the sum
    in the backend's order (see `_three_paths` for acc / extra) and
    `wta_maps` of it, with the uniqueness terms of `cost` when `unique`."""
    rl = path_plain(cost, 1, True, p1, p2)
    final = acc + rl if backend == "pallas" else extra + (acc + rl)
    return wta_maps(final, cost if unique else None)


def sgm_final(cost: torch.Tensor, acc: torch.Tensor,
              extra: Optional[torch.Tensor], p1: float, p2: float,
              backend: str, unique: bool = True) -> WtaMaps:
    """Kernel 4 on CUDA tensors (one launch, or raise); CPU tensors take
    `sgm_final_plain`. extra is None for "pallas" and tb + bt for "xla"."""
    _check_volume(cost, backend)
    if (extra is None) != (backend == "pallas"):
        raise ValueError(f"backend {backend!r} takes extra "
                         f"{'None' if backend == 'pallas' else 'tb + bt'}")
    if cost.device.type == "cpu":
        return sgm_final_plain(cost, acc, extra, p1, p2, backend, unique)
    h, w, d = cost.shape
    for name, t in (("acc", acc), ("extra", extra)):
        if t is not None:
            kernels.check_tensor(t, name, cost.dtype, cost.shape, cost.device)

    def new(dtype):
        return torch.empty((h, w), dtype=dtype, device=cost.device)

    best, best_r = new(torch.int32), new(torch.int32)
    cmin, c0, c2 = new(torch.float32), new(torch.float32), new(torch.float32)
    c_at = second = None
    if unique:
        c_at, second = new(torch.float32), new(torch.float32)
    kernels.launch("sgm_final", cost.device, cost, acc, extra, best, cmin,
                   c0, c2, best_r, c_at, second, h, w, d, p1, p2,
                   int(cost.dtype == torch.bfloat16))
    return WtaMaps(best, cmin, c0, c2, best_r, c_at, second)


def sgm_wta(cost: torch.Tensor, p1: float, p2: float, backend: str = "xla",
            unique: bool = True) -> WtaMaps:
    """SGM + winner take all of a raw (H, W, D) volume without the summed
    volume: on the card kernel 2 three times and kernel 4 once; on the CPU
    the same sums and maps from the plain versions."""
    _check_volume(cost, backend)
    acc, extra = _three_paths(cost, p1, p2, backend)
    return sgm_final(cost, acc, extra, p1, p2, backend, unique)
