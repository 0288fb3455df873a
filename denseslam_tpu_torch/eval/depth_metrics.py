"""Dense-depth quality metrics vs ground truth (a copy of
denseslam_tpu/eval/depth_metrics.py, which the port may not import).

Re-implements the reference's evaluation suite `scripts/eval_raycast_depth.py`
(reference: :47-180): crop, valid-range mask, and the metric set
MAE / RMSE / AbsRel / lg10 / SqRel / delta<1.25^k / delta<1.01^k. Used to
score raycast depth dumps against KITTI depth-completion GT (or synthetic GT
in tests).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

# reference crop: 912x228 center-bottom region (eval_raycast_depth.py:92-98)
KITTI_CROP_W = 912
KITTI_CROP_H = 228
DEPTH_MIN_M = 0.01
DEPTH_MAX_M = 50.0


def kitti_crop(img: np.ndarray) -> np.ndarray:
    """Center-crop horizontally, bottom-crop vertically to 912x228."""
    h, w = img.shape[:2]
    ch, cw = min(KITTI_CROP_H, h), min(KITTI_CROP_W, w)
    x0 = (w - cw) // 2
    y0 = h - ch
    return img[y0 : y0 + ch, x0 : x0 + cw]


def depth_metrics(
    pred_m: np.ndarray,
    gt_m: np.ndarray,
    crop: bool = False,
    min_depth: float = DEPTH_MIN_M,
    max_depth: float = DEPTH_MAX_M,
) -> Dict[str, float]:
    """Metric definitions mirror eval_raycast_depth.py:100-146."""
    if crop:
        pred_m = kitti_crop(pred_m)
        gt_m = kitti_crop(gt_m)
    mask = (gt_m > min_depth) & (gt_m < max_depth) & (pred_m > min_depth)
    n = int(mask.sum())
    if n == 0:
        return {k: float("nan") for k in [
            "mae", "rmse", "absrel", "lg10", "sqrel",
            "d1_25", "d1_25_2", "d1_25_3", "d1_01", "d1_01_2", "d1_01_3",
            "coverage", "n"]}
    p = pred_m[mask].astype(np.float64)
    g = gt_m[mask].astype(np.float64)
    err = p - g
    ratio = np.maximum(p / g, g / p)
    out = dict(
        mae=float(np.abs(err).mean()),
        rmse=float(np.sqrt((err ** 2).mean())),
        absrel=float((np.abs(err) / g).mean()),
        lg10=float(np.abs(np.log10(p) - np.log10(g)).mean()),
        sqrel=float(((err ** 2) / g).mean()),
        d1_25=float((ratio < 1.25).mean()),
        d1_25_2=float((ratio < 1.25 ** 2).mean()),
        d1_25_3=float((ratio < 1.25 ** 3).mean()),
        d1_01=float((ratio < 1.01).mean()),
        d1_01_2=float((ratio < 1.01 ** 2).mean()),
        d1_01_3=float((ratio < 1.01 ** 3).mean()),
        coverage=float(mask.mean()),
        n=n,
    )
    return out


def compare_raycast_vs_input(
    raycast_m: np.ndarray,
    input_m: np.ndarray,
    gt_m: np.ndarray,
    crop: bool = True,
) -> Tuple[Dict[str, float], Dict[str, float]]:
    """The reference's headline comparison (`test_raycast_depth` switch,
    eval_raycast_depth.py:67): fused-map raycast depth vs the raw input
    depth, both scored against GT."""
    return (
        depth_metrics(raycast_m, gt_m, crop=crop),
        depth_metrics(input_m, gt_m, crop=crop),
    )
