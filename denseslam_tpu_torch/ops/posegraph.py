"""Pose-graph optimisation, the loop-closure relaxation (port of
denseslam_tpu/ops/posegraph.py).

Fixed-cap node and edge arrays; per-edge 6-dof residuals whose exact
Jacobians come from forward-mode differentiation of the residual at xi = 0
(as `jax.jacfwd` gives them in the JAX version): one `torch.func.jvp`
over all edges and the six basis tangents at once. The normal equations
are summed by `index_put_(accumulate=True)` into a dense (6N, 6N) system
solved with `torch.linalg.solve_ex` (no error check: like the JAX
solve, a singular system gives non-finite values rather than raising,
and nothing here reads a value back to the host).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import BackendConfig
from ..device import resolve_device
from ..utils import lie
from ..utils.numerics import true_div


class PoseGraph(NamedTuple):
    T_wc: torch.Tensor         # (N, 4, 4) node poses
    node_valid: torch.Tensor   # (N,) bool
    edge_i: torch.Tensor       # (E,) int64 source node
    edge_j: torch.Tensor       # (E,) int64 target node
    T_ij: torch.Tensor         # (E, 4, 4) measured relative transform T_i^-1 T_j
    edge_weight: torch.Tensor  # (E,) f32 information weight (0 = inactive)
    fixed: torch.Tensor        # (N,) bool gauge anchors


def make_graph(cfg: BackendConfig, device=None) -> PoseGraph:
    """Empty graph at the config's caps on `device` (None = the CUDA card;
    raises without one); node 0 is the gauge anchor."""
    dev = resolve_device(device)
    n, e = cfg.max_pg_nodes, cfg.max_pg_edges
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    fixed = torch.zeros((n,), dtype=torch.bool, device=dev)
    fixed[0] = True
    return PoseGraph(
        T_wc=eye.repeat(n, 1, 1),
        node_valid=torch.zeros((n,), dtype=torch.bool, device=dev),
        edge_i=torch.zeros((e,), dtype=torch.int64, device=dev),
        edge_j=torch.zeros((e,), dtype=torch.int64, device=dev),
        T_ij=eye.repeat(e, 1, 1),
        edge_weight=torch.zeros((e,), dtype=torch.float32, device=dev),
        fixed=fixed,
    )


def _edge_residual(xi_i, xi_j, T_i, T_j, T_ij_meas):
    """r = log( T_ij_meas^-1 (exp(xi_i) T_i)^-1 (exp(xi_j) T_j) )."""
    Ti = lie.se3_exp(xi_i) @ T_i
    Tj = lie.se3_exp(xi_j) @ T_j
    return lie.se3_log(lie.inv_T(T_ij_meas) @ (lie.inv_T(Ti) @ Tj))


def edge_terms(T_i, T_j, T_meas):
    """Residuals (E, 6) and Jacobians J_i, J_j (E, 6, 6) of the edges,
    linearised at xi = 0; J[e, :, k] = d r_e / d xi_k. The six tangents
    of each side ride a leading batch axis of one forward-mode pass."""
    e = T_i.shape[0]
    dev, dt = T_i.device, T_i.dtype
    zero = torch.zeros((6, e, 6), dtype=dt, device=dev)
    basis = torch.eye(6, dtype=dt, device=dev)[:, None, :].expand(6, e, 6)
    Ti, Tj, Tm = (T[None].expand(6, e, 4, 4) for T in (T_i, T_j, T_meas))
    r, dr_i = torch.func.jvp(
        lambda x: _edge_residual(x, zero, Ti, Tj, Tm), (zero,), (basis,))
    _, dr_j = torch.func.jvp(
        lambda x: _edge_residual(zero, x, Ti, Tj, Tm), (zero,), (basis,))
    # dr (6 tangents, E, 6 outputs) -> (E, 6 outputs, 6 tangents)
    return r[0], dr_i.permute(1, 2, 0), dr_j.permute(1, 2, 0)


def optimize(g: PoseGraph, cfg: BackendConfig, iters: int | None = None) -> PoseGraph:
    """Gauss-Newton relaxation of all active nodes."""
    n = g.T_wc.shape[0]
    dev = g.T_wc.device
    iters = cfg.pg_iters if iters is None else iters
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    eye6n = torch.eye(6 * n, dtype=torch.float32, device=dev)
    diag_n = torch.arange(n, device=dev)
    pin = g.fixed | ~g.node_valid          # gauge + inactive nodes
    ei, ej = g.edge_i, g.edge_j
    w = g.edge_weight[:, None, None]
    T_wc = g.T_wc
    for _ in range(iters):
        r, J_i, J_j = edge_terms(T_wc[ei], T_wc[ej], g.T_ij)
        JiT = J_i.transpose(-1, -2)
        JjT = J_j.transpose(-1, -2)
        H = torch.zeros((n, n, 6, 6), dtype=torch.float32, device=dev)
        b = torch.zeros((n, 6), dtype=torch.float32, device=dev)
        H.index_put_((ei, ei), w * (JiT @ J_i), accumulate=True)
        H.index_put_((ej, ej), w * (JjT @ J_j), accumulate=True)
        H.index_put_((ei, ej), w * (JiT @ J_j), accumulate=True)
        H.index_put_((ej, ei), w * (JjT @ J_i), accumulate=True)
        b.index_put_((ei,), w[..., 0] * (JiT @ r[..., None])[..., 0],
                     accumulate=True)
        b.index_put_((ej,), w[..., 0] * (JjT @ r[..., None])[..., 0],
                     accumulate=True)

        H = torch.where(pin[:, None, None, None] | pin[None, :, None, None],
                        0.0, H)
        H[diag_n, diag_n] += pin.to(torch.float32)[:, None, None] * eye6
        b = torch.where(pin[:, None], 0.0, b)

        H_dense = H.permute(0, 2, 1, 3).reshape(6 * n, 6 * n)
        damp = true_div(1e-6 * torch.trace(H_dense), 6 * n) + 1e-8
        dx = -torch.linalg.solve_ex(H_dense + damp * eye6n, b.reshape(-1),
                                    check_errors=False)[0].reshape(n, 6)
        dx = torch.clamp(dx, -1.0, 1.0)
        T_wc = lie.se3_exp(dx) @ T_wc
    return g._replace(T_wc=T_wc)


def total_error(g: PoseGraph) -> torch.Tensor:
    """Sum of weighted squared edge residual norms (diagnostic)."""
    Ti = g.T_wc[g.edge_i]
    Tj = g.T_wc[g.edge_j]
    zero = torch.zeros((Ti.shape[0], 6), dtype=Ti.dtype, device=Ti.device)
    r = _edge_residual(zero, zero, Ti, Tj, g.T_ij)
    return (g.edge_weight * (r * r).sum(dim=-1)).sum()
