"""Synthetic stereo sequence generator (port of
denseslam_tpu/io/synthetic.py): an analytic scene of spheres, a ground
plane, a back wall and street side walls, rendered with exact z-depth and
an aperiodic world-anchored value-noise texture. Gives the port
KITTI-scale inputs without JAX.

Rendering is batched over the pose axis and runs on the device of the
poses tensor (or `device`, for numpy poses). The card and the CPU render
the same bits: square roots are correctly rounded on both
(utils/numerics.py `sqrt`; the CPU's `torch.sqrt` is not), and a division
by a constant is a product with the constant's float32 reciprocal on
both, which is how the card divides a tensor by a Python number
(`_div`)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.hash import wrap_i32
from ..utils import lie
from ..utils.numerics import sqrt
from ..utils.camera import Intrinsics, StereoRig


class Scene(NamedTuple):
    sphere_centers: np.ndarray  # (S, 3) world frame, f32
    sphere_radii: np.ndarray    # (S,) f32
    plane_y: float              # ground plane y = plane_y (y down)
    wall_z: float               # back wall z = wall_z
    side_x: float = -1.0        # |x| = side_x street walls; <= 0 disables


def default_scene() -> Scene:
    centers = np.array(
        [[0.0, 0.0, 2.5], [-1.0, -0.3, 3.5], [1.2, 0.4, 4.0], [0.3, -0.8, 5.5]],
        dtype=np.float32)
    radii = np.array([0.6, 0.45, 0.7, 0.5], dtype=np.float32)
    return Scene(centers, radii, plane_y=1.2, wall_z=8.0)


def street_scene(length_m: float = 80.0, width_m: float = 14.0,
                 seed: int = 7, n_spheres: int = 24) -> Scene:
    """KITTI-like street corridor: ground plane at camera height, building
    walls at x = +-width/2, obstacle spheres along the path, far end wall."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(4.0, length_m - 5.0, n_spheres)
    x = rng.uniform(-width_m / 2 + 1.0, width_m / 2 - 1.0, n_spheres)
    r = rng.uniform(0.3, 1.1, n_spheres)
    y = 1.65 - r  # resting on the ground plane
    centers = np.stack([x, y, z], -1).astype(np.float32)
    return Scene(centers, r.astype(np.float32), plane_y=1.65,
                 wall_z=float(length_m), side_x=float(width_m / 2))


def loop_scene(poses: np.ndarray, seed: int = 11,
               n_spheres: int = 48) -> Scene:
    """Open scene for loop drives: a textured ground plane and sphere
    occluders scattered laterally around the trajectory `poses`, no walls
    (a circular path revisits its start with the same heading)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.4, 1.3, n_spheres)
    idx = rng.integers(0, len(poses), n_spheres)
    lateral = rng.uniform(2.0, 7.0, n_spheres) * rng.choice(
        [-1.0, 1.0], n_spheres)
    ahead = rng.uniform(-2.0, 2.0, n_spheres)
    centers = np.empty((n_spheres, 3), np.float32)
    for k in range(n_spheres):
        T = poses[idx[k]]
        p = T[:3, 3] + T[:3, 0] * lateral[k] + T[:3, 2] * ahead[k]
        centers[k] = [p[0], 1.65 - r[k], p[2]]
    span = float(np.abs(poses[:, :3, 3]).max()) + 50.0
    return Scene(centers, r.astype(np.float32), plane_y=1.65, wall_z=span,
                 side_x=-1.0)


def make_loop_trajectory(n_frames: int, radius_m: float = 15.0,
                         closure_frames: int = 0) -> np.ndarray:
    """Circular T_wc trajectory through the origin: a full circle of
    `radius_m` in `n_frames` frames, then `closure_frames` more past the
    start (an exact revisit with the same heading). Pure numpy."""
    yaw = 2.0 * np.pi / n_frames
    step = yaw * radius_m
    xi = np.array([0.0, 0.0, step, 0.0, yaw, 0.0], dtype=np.float32)
    dT = np.asarray(lie.se3_exp_np(xi))
    poses = []
    T = np.eye(4, dtype=np.float32)
    for _ in range(n_frames + closure_frames):
        poses.append(T.copy())
        T = (T @ dT).astype(np.float32)
    return np.stack(poses)


def make_trajectory(n_frames: int, step_m: float = 0.05,
                    yaw_rate: float = 0.004) -> np.ndarray:
    """Forward+turn trajectory of T_wc poses, (N, 4, 4) float32 (numpy)."""
    xi = np.array([0.0, 0.0, step_m, 0.0, yaw_rate, 0.0], dtype=np.float32)
    dT = np.asarray(lie.se3_exp_np(xi))
    poses = []
    T = np.eye(4, dtype=np.float32)
    for _ in range(n_frames):
        poses.append(T.copy())
        T = (T @ dT).astype(np.float32)
    return np.stack(poses)


def _ray_scene_depth(ox, oy, oz, dx, dy, dz, centers, radii, plane_y,
                     wall_z, side_x):
    """Analytic ray-scene intersection; returns ray depth t (0 = miss)."""
    big = 1e9
    t_best = torch.full_like(dx, big)
    # dirs are z-normalised (not unit), so keep the |d|^2 term
    a = dx * dx + dy * dy + dz * dz
    for i in range(centers.shape[0]):
        ocx = ox - centers[i, 0]
        ocy = oy - centers[i, 1]
        ocz = oz - centers[i, 2]
        b = ocx * dx + ocy * dy + ocz * dz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - radii[i] * radii[i]
        disc = b * b - a * cc
        hit = disc > 0
        sq = sqrt(torch.clamp(disc, min=0.0))
        t = (-b - sq) / a
        t = torch.where(hit & (t > 1e-3), t, big)
        t_best = torch.minimum(t_best, t)

    def planar(d, o, level):
        ok = d.abs() > 1e-6
        tq = torch.where(ok, (level - o) / torch.where(ok, d, 1.0), big)
        return torch.where(tq > 1e-3, tq, big)

    t_best = torch.minimum(t_best, planar(dy, oy, plane_y))    # ground
    t_best = torch.minimum(t_best, planar(dz, oz, wall_z))     # back wall
    if side_x > 0:                                             # street walls
        for wx in (side_x, -side_x):
            t_best = torch.minimum(t_best, planar(dx, ox, wx))
    return torch.where(t_best < big * 0.5, t_best, 0.0)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d for a float32 tensor and a Python number, as x times d's
    float32 reciprocal on every device."""
    return x * float(np.float32(1.0) / np.float32(d))


def _hash3(cx, cy, cz):
    """Integer lattice hash with int32 wrap-around -> [-1, 1]."""
    h = wrap_i32(wrap_i32(cx.long() * 374761393).long()
                 + wrap_i32(cy.long() * 668265263).long()
                 + wrap_i32(cz.long() * 1274126177).long())
    h = wrap_i32((h ^ (h >> 13)).long() * 1103515245)
    h = h ^ (h >> 16)
    return _div((h & 0x7FFF).to(torch.float32), 16383.5) - 1.0


def _value_noise(px, py, pz, freq: float):
    """Hash-lattice value noise in [-1, 1]: aperiodic, world-anchored."""
    gx, gy, gz = px * freq, py * freq, pz * freq
    g0x = torch.floor(gx).clamp_(-(2 ** 30), 2 ** 30).to(torch.int32)
    g0y = torch.floor(gy).clamp_(-(2 ** 30), 2 ** 30).to(torch.int32)
    g0z = torch.floor(gz).clamp_(-(2 ** 30), 2 ** 30).to(torch.int32)
    fx, fy, fz = gx - g0x, gy - g0y, gz - g0z
    wx = fx * fx * (3.0 - 2.0 * fx)
    wy = fy * fy * (3.0 - 2.0 * fy)
    wz = fz * fz * (3.0 - 2.0 * fz)
    acc = 0.0
    for dz_ in (0, 1):
        for dy_ in (0, 1):
            for dx_ in (0, 1):
                val = _hash3(g0x + dx_, g0y + dy_, g0z + dz_)
                wt = ((wx if dx_ else 1 - wx) * (wy if dy_ else 1 - wy)
                      * (wz if dz_ else 1 - wz))
                acc = acc + val * wt
    return acc


def _texture(px, py, pz):
    """Multi-octave value-noise intensity in [5, 250]."""
    v = (_value_noise(px, py, pz, 3.1)
         + 0.6 * _value_noise(px, py, pz, 7.7)
         + 0.35 * _value_noise(px, py, pz, 17.3)
         + 0.18 * _value_noise(px, py, pz, 39.9))
    return torch.clamp(128.0 + 90.0 * v, 5.0, 250.0)


def _render_batch(T_wc: torch.Tensor, intr: Intrinsics, scene: Scene):
    """(N, 4, 4) poses -> ((N, H, W) gray, (N, H, W) z-depth)."""
    dev = T_wc.device
    h, w = intr.height, intr.width
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    dcx = _div(u - intr.cx, intr.fx)
    dcy = _div(v - intr.cy, intr.fy)
    R = T_wc[:, :3, :3, None, None]
    t = T_wc[:, :3, 3, None, None]
    dwx = R[:, 0, 0] * dcx + R[:, 0, 1] * dcy + R[:, 0, 2]
    dwy = R[:, 1, 0] * dcx + R[:, 1, 1] * dcy + R[:, 1, 2]
    dwz = R[:, 2, 0] * dcx + R[:, 2, 1] * dcy + R[:, 2, 2]
    ox, oy, oz = t[:, 0], t[:, 1], t[:, 2]
    centers = torch.as_tensor(scene.sphere_centers, dtype=torch.float32,
                              device=dev)
    radii = torch.as_tensor(scene.sphere_radii, dtype=torch.float32,
                            device=dev)
    tz = _ray_scene_depth(ox, oy, oz, dwx, dwy, dwz, centers, radii,
                          float(scene.plane_y), float(scene.wall_z),
                          float(scene.side_x))
    px = ox + dwx * tz
    py = oy + dwy * tz
    pz = oz + dwz * tz
    gray = torch.where(tz > 0, _texture(px, py, pz), 0.0)
    return gray, tz


def _poses(poses, device) -> torch.Tensor:
    """Poses as f32 on their own device (tensors) or on `device` (numpy;
    None = the CUDA card)."""
    if isinstance(poses, torch.Tensor):
        dev = poses.device if device is None else device
        return poses.to(dtype=torch.float32, device=dev)
    return torch.as_tensor(np.asarray(poses, np.float32),
                           device=resolve_device(device))


def render_trajectory(poses, intr: Intrinsics, scene: Scene | None = None,
                      device=None, batch: int = 8):
    """Render a pose batch (N, 4, 4) -> ((N, H, W) gray, (N, H, W) depth),
    `batch` frames at a time."""
    if scene is None:
        scene = default_scene()
    T = _poses(poses, device)
    outs = [_render_batch(T[i:i + batch], intr, scene)
            for i in range(0, T.shape[0], batch)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def render_view(T_wc, intr: Intrinsics, scene: Scene | None = None,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render (gray, depth_m) from one camera pose T_wc (camera-to-world)."""
    g, d = render_trajectory(_poses(T_wc, device)[None], intr, scene)
    return g[0], d[0]


def right_poses(poses: torch.Tensor, baseline_m: float) -> torch.Tensor:
    """Right-camera poses T_wc @ [I | (b, 0, 0)], with the translation
    formed as the JAX reference's dot forms it: round(R[:, 0] * b) + t."""
    out = poses.clone()
    out[..., :3, 3] = poses[..., :3, 0] * baseline_m + poses[..., :3, 3]
    return out


def render_stereo(T_wc, rig: StereoRig, scene: Scene | None = None,
                  device=None):
    """Render a rectified stereo pair + left depth from the left camera's
    pose: (left gray, right gray, left depth)."""
    lg, rg, ld = render_stereo_trajectory(_poses(T_wc, device)[None], rig,
                                          scene)
    return lg[0], rg[0], ld[0]


def render_stereo_trajectory(poses, rig: StereoRig, scene: Scene | None = None,
                             device=None):
    """Batched stereo render: (N, 4, 4) -> (lefts, rights, left_depths)."""
    T = _poses(poses, device)
    lg, ld = render_trajectory(T, rig.intr, scene)
    rg, _ = render_trajectory(right_poses(T, rig.baseline_m), rig.intr, scene)
    return lg, rg, ld
