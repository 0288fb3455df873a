"""Dataset input: KITTI (odometry/tracking/raw), TUM RGB-D, ICL-NUIM (port
of denseslam_tpu/io/datasets.py, without cv2: io/png.py decodes, converts to
gray and resizes as cv2 does; frames stay numpy arrays).

Equivalent surface to the reference's `Input` class + per-dataset Config
presets (reference: src/DenseSLAM/Input.h:24-165, Input.cpp:25-171):
sensor enums, folder layouts, calibration, TUM associate pairing, per-frame
reading with center-crop to the calibrated size and optional low-res mode.
Depth conventions follow PrecomputedDepthProvider (reference:
src/DenseSLAM/PrecomputedDepthProvider.cpp:30-68): KITTI depth PNGs are
depth*256, TUM/ICL depth PNGs are depth*5000 (mm = png/5).

Defects of the JAX reader, kept so that both readers give the same frames
(ROADMAP.md Queue C, "Known JAX defects"):
  * `io_backend="native"` decodes colour as RGB where the cv2 path gives
    BGR, and converts it to gray in float with 0.299 / 0.587 / 0.114 and no
    rounding, where cv2 uses its fixed-point rule: the two backends give
    different pixels for colour input;
  * `prefetch_iter` never applies `input_scale`'s resize: at
    input_scale != 1 it yields frames at the unscaled crop size while
    `self.rig` is scaled;
  * with `use_color`, frames are BGR (cv2's order), and the consumers
    (`DenseSLAM.process_frame`, the command line's chunk path) pass them to
    `rgb_to_gray` as RGB, so the R and B weights are swapped.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import List, Optional, Tuple

import numpy as np

from ..utils.camera import Intrinsics, StereoRig
from . import pfm, png


class Sensor(enum.Enum):
    """reference: src/DenseSLAM/Input.h:24-28"""
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


class DatasetType(enum.Enum):
    """reference: src/DenseSLAM/Input.h:30-35"""
    KITTI_ODOMETRY = 0
    KITTI_TRACKING = 1
    KITTI_RAW = 2
    TUM = 3
    ICL_NUIM = 4


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """Folder layout preset (reference: Input.h:37-165)."""
    dataset: DatasetType
    left_gray_folder: str
    right_gray_folder: str
    left_color_folder: str
    right_color_folder: str
    depth_folder: str
    calibration_fname: str
    frame_fmt: str            # e.g. "{:06d}.png"
    depth_is_disparity: bool  # disparity maps (ELAS/DispNet) vs depth maps
    depth_png_scale: float    # depth_m = png / depth_png_scale
    timestamped: bool = False  # TUM-style associate pairing


def kitti_odometry_config() -> DatasetConfig:
    return DatasetConfig(
        dataset=DatasetType.KITTI_ODOMETRY,
        left_gray_folder="image_0",
        right_gray_folder="image_1",
        left_color_folder="image_2",
        right_color_folder="image_3",
        depth_folder="precomputed-depth",
        calibration_fname="calib.txt",
        frame_fmt="{:06d}.png",
        depth_is_disparity=True,
        depth_png_scale=256.0,
    )


def kitti_tracking_config() -> DatasetConfig:
    return dataclasses.replace(
        kitti_odometry_config(),
        dataset=DatasetType.KITTI_TRACKING,
        calibration_fname="calib.txt",
    )


def kitti_raw_config() -> DatasetConfig:
    return dataclasses.replace(
        kitti_odometry_config(),
        dataset=DatasetType.KITTI_RAW,
        left_gray_folder="image_00/data",
        right_gray_folder="image_01/data",
        left_color_folder="image_02/data",
        right_color_folder="image_03/data",
        frame_fmt="{:010d}.png",
    )


def tum_config() -> DatasetConfig:
    return DatasetConfig(
        dataset=DatasetType.TUM,
        left_gray_folder="rgb",
        right_gray_folder="",
        left_color_folder="rgb",
        right_color_folder="",
        depth_folder="depth",
        calibration_fname="",
        frame_fmt="{}.png",
        depth_is_disparity=False,
        depth_png_scale=5000.0,
        timestamped=True,
    )


def icl_nuim_config() -> DatasetConfig:
    return dataclasses.replace(
        tum_config(), dataset=DatasetType.ICL_NUIM,
    )


CONFIGS = {
    DatasetType.KITTI_ODOMETRY: kitti_odometry_config,
    DatasetType.KITTI_TRACKING: kitti_tracking_config,
    DatasetType.KITTI_RAW: kitti_raw_config,
    DatasetType.TUM: tum_config,
    DatasetType.ICL_NUIM: icl_nuim_config,
}


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

def read_kitti_calib(path: str) -> Tuple[Intrinsics, float]:
    """Parse KITTI calib.txt (P0..P3 projection rows) -> (intrinsics,
    baseline_m). Baseline from P1's -fx*B tx entry
    (reference analog: SystemEntry.cpp:51-65 ReadOdometryCalibration)."""
    mats = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            nums = [float(x) for x in vals.split()]
            if len(nums) == 12:
                mats[key.strip()] = np.asarray(nums, np.float64).reshape(3, 4)
    p0 = mats.get("P0", mats.get("P2"))
    p1 = mats.get("P1", mats.get("P3"))
    fx, fy = p0[0, 0], p0[1, 1]
    cx, cy = p0[0, 2], p0[1, 2]
    baseline = float(-p1[0, 3] / p1[0, 0])
    # image size is not in calib.txt; caller overrides from first frame
    intr = Intrinsics(fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
                      width=0, height=0)
    return intr, baseline


TUM_INTRINSICS = {
    # freiburg1/2/3 defaults (TUM benchmark website values)
    "fr1": Intrinsics(517.3, 516.5, 318.6, 255.3, 640, 480),
    "fr2": Intrinsics(520.9, 521.0, 325.1, 249.7, 640, 480),
    "fr3": Intrinsics(535.4, 539.2, 320.1, 247.6, 640, 480),
}

ICL_INTRINSICS = Intrinsics(481.2, -480.0, 319.5, 239.5, 640, 480)


# ---------------------------------------------------------------------------
# TUM associate (reference: Input.h:207-218)
# ---------------------------------------------------------------------------

def associate(ts_a: List[float], ts_b: List[float],
              max_dt: float = 0.02) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp pairing of two streams."""
    pairs = []
    j = 0
    used = set()
    for i, ta in enumerate(ts_a):
        best, best_dt = -1, max_dt
        while j > 0 and ts_b[j - 1] > ta:
            j -= 1
        for k in range(max(j - 2, 0), len(ts_b)):
            dt = abs(ts_b[k] - ta)
            if dt <= best_dt and k not in used:
                best, best_dt = k, dt
            if ts_b[k] > ta + max_dt:
                break
        if best >= 0:
            pairs.append((i, best))
            used.add(best)
            j = best
    return pairs


# ---------------------------------------------------------------------------
# Input
# ---------------------------------------------------------------------------

class Input:
    """Frame streamer (reference: Input.{h,cpp} — ReadNextFrame /
    HasMoreImages / GetCvImages / frame_offset / input_scale)."""

    def __init__(
        self,
        root: str,
        config: DatasetConfig,
        rig: Optional[StereoRig] = None,
        frame_offset: int = 0,
        frame_limit: Optional[int] = None,
        input_scale: float = 1.0,
        use_color: bool = False,
        io_backend: str = "cv2",     # "cv2" (io/png.py) | "native" (dsio.cpp)
    ):
        self._native = None
        if io_backend == "native":
            from . import native as native_io
            native_io.ensure_built()
            self._native = native_io
        self.root = root
        self.config = config
        self.frame_offset = frame_offset
        self.input_scale = input_scale
        self.use_color = use_color
        self.frame_idx = frame_offset

        left_folder = (config.left_color_folder if use_color
                       else config.left_gray_folder)
        self.left_dir = os.path.join(root, left_folder)
        self.right_dir = (
            os.path.join(root, config.right_color_folder if use_color
                         else config.right_gray_folder)
            if config.right_gray_folder else None
        )
        self.depth_dir = os.path.join(root, config.depth_folder)

        if config.timestamped:
            self._index_timestamped()
        else:
            names = sorted(os.listdir(self.left_dir))
            self.frames = [(os.path.join(self.left_dir, n),
                            os.path.join(self.right_dir, n) if self.right_dir else None,
                            os.path.join(self.depth_dir, n),
                            float(i))
                           for i, n in enumerate(names)]
        if frame_limit is not None:
            self.frames = self.frames[: frame_offset + frame_limit]

        # calibration
        if rig is not None:
            self.rig = rig
        else:
            self.rig = self._load_calibration()
        if self.rig.intr.width == 0 and self.frames:
            img = self._imread(self.frames[0][0])
            h, w = img.shape[:2]
            intr = self.rig.intr._replace(width=w, height=h)
            self.rig = self.rig._replace(intr=intr)
        if input_scale != 1.0:
            self.rig = self.rig._replace(intr=self.rig.intr.scaled(input_scale))

    # -- indexing ----------------------------------------------------------

    def _index_timestamped(self) -> None:
        def scan(d):
            entries = []
            for n in sorted(os.listdir(d)):
                if n.endswith(".png"):
                    try:
                        entries.append((float(n[:-4]), os.path.join(d, n)))
                    except ValueError:
                        pass
            return entries

        rgb = scan(self.left_dir)
        depth = scan(self.depth_dir)
        pairs = associate([t for t, _ in rgb], [t for t, _ in depth])
        self.frames = [
            (rgb[i][1], None, depth[j][1], rgb[i][0]) for i, j in pairs
        ]

    def _load_calibration(self) -> StereoRig:
        c = self.config
        if c.dataset in (DatasetType.KITTI_ODOMETRY, DatasetType.KITTI_TRACKING,
                         DatasetType.KITTI_RAW):
            intr, baseline = read_kitti_calib(
                os.path.join(self.root, c.calibration_fname))
            return StereoRig(intr=intr, baseline_m=baseline)
        if c.dataset == DatasetType.TUM:
            key = "fr1"
            for k in TUM_INTRINSICS:
                if k in os.path.basename(os.path.normpath(self.root)).replace(
                        "freiburg", "fr"):
                    key = k
            return StereoRig(intr=TUM_INTRINSICS[key], baseline_m=0.1)
        return StereoRig(intr=ICL_INTRINSICS, baseline_m=0.1)

    # -- reading -----------------------------------------------------------

    def has_more_images(self) -> bool:
        return self.frame_idx < len(self.frames)

    def _imread(self, path: str, gray: bool = True) -> np.ndarray:
        if self._native is not None:
            img = self._native.read_png(path)
            if gray and img.ndim == 3:
                # native decoder returns RGB order
                img = (
                    0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
                )
            return img
        img = png.read_png(path)
        if gray and img.ndim == 3:
            img = png.bgr_to_gray(img)
        return img

    def _read_depth(self, path: str) -> np.ndarray:
        """Returns depth in meters, 0 = invalid, or disparity (px) when
        depth_is_disparity."""
        if path.endswith(".pfm") or not os.path.exists(path):
            pfm_path = path[:-4] + ".pfm"
            if os.path.exists(pfm_path):
                if self._native is not None:
                    return self._native.read_pfm(pfm_path)
                return pfm.read_pfm(pfm_path)  # disparity float
        img = self._imread(path, gray=False)
        if self.config.depth_is_disparity:
            return img.astype(np.float32)      # disparity stored directly
        return img.astype(np.float32) / self.config.depth_png_scale

    def read_next_frame(self):
        """Returns dict(left, right, depth_m, timestamp). Arrays are float32;
        images in [0, 255]; depth in meters (0 invalid). Applies center-crop
        to the calibrated size (Input.cpp:71-76) and low-res resize
        (Input.cpp:117-138)."""
        if not self.has_more_images():
            raise StopIteration
        lp, rp, dp, ts = self.frames[self.frame_idx]
        self.frame_idx += 1

        left = self._imread(lp, gray=not self.use_color).astype(np.float32)
        right = (self._imread(rp, gray=not self.use_color).astype(np.float32)
                 if rp else None)
        raw_depth = self._read_depth(dp)

        if self.config.depth_is_disparity:
            disp = self._center_crop(raw_depth)
            fb = self.rig.intr.fx * self.rig.baseline_m / max(self.input_scale, 1e-9)
            with np.errstate(divide="ignore", invalid="ignore"):
                depth = np.where(disp > 0.1, fb / np.maximum(disp, 0.1), 0.0)
        else:
            depth = self._center_crop(raw_depth)

        left = self._center_crop(left)
        if right is not None:
            right = self._center_crop(right)

        if self.input_scale != 1.0:
            sz = (self.rig.intr.width, self.rig.intr.height)
            left = png.resize_area(left, sz)
            if right is not None:
                right = png.resize_area(right, sz)
            depth = png.resize_nearest(depth, sz)
        return dict(left=left, right=right, depth=depth.astype(np.float32),
                    timestamp=ts)

    def _center_crop(self, img: np.ndarray) -> np.ndarray:
        """Crop to calibrated size, matching the reference's center crop
        (Input.cpp:71-76). Applied pre-scale."""
        if self.input_scale != 1.0:
            th = int(round(self.rig.intr.height / self.input_scale))
            tw = int(round(self.rig.intr.width / self.input_scale))
        else:
            th, tw = self.rig.intr.height, self.rig.intr.width
        h, w = img.shape[:2]
        if (h, w) == (th, tw):
            return img
        y0 = max((h - th) // 2, 0)
        x0 = max((w - tw) // 2, 0)
        return img[y0 : y0 + th, x0 : x0 + tw]

    def __iter__(self):
        while self.has_more_images():
            yield self.read_next_frame()

    def prefetch_iter(self, ahead: int = 4, threads: int = 2):
        """Iterate frames with the native threaded prefetcher hiding disk
        latency behind compute (the loader in native/dsio.cpp). Depth
        conversion/cropping still runs on the consumer thread. Like the
        JAX reader it never applies input_scale's resize (see the module
        docstring)."""
        from . import native as native_io

        native_io.ensure_built()
        start = self.frame_idx
        remaining = self.frames[start:]
        left_paths = [f[0] for f in remaining]
        right_paths = [f[1] for f in remaining if f[1]]
        depth_paths = []
        for _, _, dp, _ in remaining:
            pfm_path = dp[:-4] + ".pfm"
            depth_paths.append(
                pfm_path if (not os.path.exists(dp) and os.path.exists(pfm_path))
                else dp
            )
        loaders = [native_io.PrefetchLoader(left_paths, ahead, threads),
                   native_io.PrefetchLoader(depth_paths, ahead, threads)]
        if right_paths:
            loaders.insert(1, native_io.PrefetchLoader(right_paths, ahead, threads))
        try:
            for i, fr in enumerate(remaining):
                self.frame_idx = start + i + 1
                left = loaders[0].next()
                right = loaders[1].next() if len(loaders) == 3 else None
                raw_depth = loaders[-1].next()
                if left is None or raw_depth is None:
                    return
                if left.ndim == 3 and not self.use_color:
                    left = (0.299 * left[..., 0] + 0.587 * left[..., 1]
                            + 0.114 * left[..., 2])
                if right is not None and right.ndim == 3 and not self.use_color:
                    right = (0.299 * right[..., 0] + 0.587 * right[..., 1]
                             + 0.114 * right[..., 2])
                if self.config.depth_is_disparity:
                    disp = self._center_crop(raw_depth)
                    fb = self.rig.intr.fx * self.rig.baseline_m / max(self.input_scale, 1e-9)
                    depth = np.where(disp > 0.1, fb / np.maximum(disp, 0.1), 0.0)
                else:
                    depth = self._center_crop(raw_depth) / self.config.depth_png_scale
                left = self._center_crop(left)
                if right is not None:
                    right = self._center_crop(right)
                yield dict(left=left.astype(np.float32),
                           right=None if right is None else right.astype(np.float32),
                           depth=depth.astype(np.float32), timestamp=fr[3])
        finally:
            for ld in loaders:
                ld.close()
