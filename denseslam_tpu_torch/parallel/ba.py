"""Distributed Schur-complement bundle adjustment over the map axis (port
of denseslam_tpu/parallel/ba.py).

The landmarks and their observations are split over the ranks; the
camera-side sums (U blocks, the Schur complement S = U - W V^-1 W^T, the
gradient, the costs) are all-reduced as (6K, 6K)-sized tensors, while
every landmark block (V, V^-1, dx_p) stays on its rank. The reduced camera
solve is the same on every rank. See ops/ba.py `solve`'s `mesh` for where
the collectives land.
"""

from __future__ import annotations

import functools

from ..config import BackendConfig
from ..ops import ba
from ..utils.camera import StereoRig
from .mesh import MapMesh


def landmark_slice(n_landmarks: int, mesh: MapMesh) -> slice:
    """This rank's contiguous slice of the landmark axis (L must divide by
    the ranks, as JAX's P(MAP_AXIS) sharding requires)."""
    if n_landmarks % mesh.size:
        raise ValueError(f"{n_landmarks} landmarks do not split over "
                         f"{mesh.size} ranks")
    n = n_landmarks // mesh.size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def shard_problem(problem: ba.BAProblem, mesh: MapMesh) -> ba.BAProblem:
    """This rank's part of a whole problem: its landmark slice of
    points_w, obs, obs_mask and point_valid; the cameras whole."""
    sl = landmark_slice(problem.points_w.shape[0], mesh)
    return problem._replace(points_w=problem.points_w[sl],
                            obs=problem.obs[sl], obs_mask=problem.obs_mask[sl],
                            point_valid=problem.point_valid[sl])


def make_sharded_solver(mesh: MapMesh, rig: StereoRig, cfg: BackendConfig):
    """A solver of this rank's landmark slice of a problem
    (`shard_problem`): the cameras, costs and counts of the result are the
    whole problem's, its points_w this rank's slice."""
    return functools.partial(ba.solve, rig=rig, cfg=cfg, mesh=mesh)
