"""Trajectory file IO: TUM and KITTI formats (a copy of
denseslam_tpu/io/trajectory.py).

Equivalent surface to SaveTUMTrajectory (reference: DenseSlam.h:415-417,
written at SystemEntry.cpp:361) and orbSaveTrajectoryKITTI
(reference: OrbSLAMDriver.h:92-94).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> (qx, qy, qz, qw), Shepperd's method (stable)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        qw = (R[2, 1] - R[1, 2]) / s
        qx = 0.25 * s
        qy = (R[0, 1] + R[1, 0]) / s
        qz = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        qw = (R[0, 2] - R[2, 0]) / s
        qx = (R[0, 1] + R[1, 0]) / s
        qy = 0.25 * s
        qz = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        qw = (R[1, 0] - R[0, 1]) / s
        qx = (R[0, 2] + R[2, 0]) / s
        qy = (R[1, 2] + R[2, 1]) / s
        qz = 0.25 * s
    return np.array([qx, qy, qz, qw], np.float64)


def quaternion_to_rotation(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 2.0 / n if n > 0 else 0.0
    return np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
            [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
            [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
        ],
        np.float64,
    )


def save_tum(path: str, entries: Sequence[Tuple[float, np.ndarray]]) -> None:
    """entries: (timestamp, T_wc 4x4). TUM line: t tx ty tz qx qy qz qw."""
    with open(path, "w") as f:
        for ts, T in entries:
            T = np.asarray(T, np.float64)
            q = rotation_to_quaternion(T[:3, :3])
            t = T[:3, 3]
            f.write(
                f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def load_tum(path: str) -> List[Tuple[float, np.ndarray]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            T = np.eye(4)
            T[:3, :3] = quaternion_to_rotation(np.asarray(v[4:8]))
            T[:3, 3] = v[1:4]
            out.append((v[0], T))
    return out


def save_kitti(path: str, poses: Sequence[np.ndarray]) -> None:
    """KITTI line: 12 row-major entries of the 3x4 pose (T_wc)."""
    with open(path, "w") as f:
        for T in poses:
            T = np.asarray(T, np.float64)
            f.write(" ".join(f"{x:.9e}" for x in T[:3, :4].reshape(-1)) + "\n")


def load_kitti(path: str) -> List[np.ndarray]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            v = np.asarray([float(x) for x in line.split()]).reshape(3, 4)
            T = np.eye(4)
            T[:3, :4] = v
            out.append(T)
    return out
