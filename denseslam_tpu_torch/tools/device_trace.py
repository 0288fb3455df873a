"""Where the card and the CPU part, traced from equal inputs.

    python -m denseslam_tpu_torch.tools.device_trace vo [--json PATH]
    python -m denseslam_tpu_torch.tools.device_trace ba [--json PATH]

vo: A4's drift golden (tests/test_vo_numerics.py:185, chip_smoke.py
`vo_drift`): the flagship loop's first 96 frames at 1226x370 under its
gain ramp and noise, with the JAX frontend's RANSAC draws, all made on the
CPU (utils/threefry.py) and the same bytes copied to the card. Open-loop
`vo_step` runs on both devices. Per frame, the distance between the two
positions. The first frame where the poses differ in any bit, and the
first where they part by more than 1e-5 m. Each device's KITTI t_err over
10 and 15 m segments, and its end error. Then each call of the VO's
stages and ops (TRACED) made on the card during the first
`--recheck-frames` frames is recomputed on the CPU from the same inputs.
For each traced function the record gives its calls, how many are equal
bit for bit, and the first frame where one is not: an op that parts
there parts from equal inputs.

ba: the flagship drive's first local BA window (keyframes 0, 4, 8 and 12
of the loop at their true poses, tests/test_torch_drive_ba.py), built on
the CPU. ops/ba.py `solve` runs on the card and the CPU in float32, and
on the CPU in float64 as the oracle. The record gives each keyframe
position's distance to the oracle on both devices, the card against the
CPU, and each damped step's accept decision on all three.

The record is printed as one JSON line and written to --json (default
under build/). The imports are absolute, so the tool can also trace
another checkout of the package: put that checkout first on PYTHONPATH
and run this file by its path.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import math
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FRAMES = 96
PART_M = 1e-5
# (module, function): the stereo VO's stages as frontend.vo_step calls
# them, then the ops inside them
TRACED = (
    ("features", "detect"), ("matching", "quad_match"),
    ("matching", "remove_outliers"), ("matching", "refine_quad_subpix"),
    ("matching", "stereo_disparities"), ("ransac", "estimate_stereo_motion"),
    ("matching", "estimate_gain"),
    ("features", "describe"), ("matching", "_zssd"),
    ("ransac", "_gn_jacobian"), ("ransac", "_reproject_residuals"),
    ("ransac", "_gn_refine"), ("ransac", "gn_normal"),
    ("ransac", "gn_update"),
)
# the ops that used to part (ROADMAP.md Queue C): the three of C 4, then
# the reprojection's transform and the Gauss-Newton's sums of C 1
VO_OPS = (("features", "describe"), ("ransac", "_gn_jacobian"),
          ("matching", "_zssd"), ("ransac", "_reproject_residuals"),
          ("ransac", "_gn_refine"))


def _to(x, device):
    """`x` with every tensor inside it (tuples, lists) moved to `device`."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_to(v, device) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return x


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def same_bits(a, b) -> bool:
    """Equal bit for bit: every tensor leaf of `a` and `b` (on the host)."""
    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if torch.is_tensor(x) != torch.is_tensor(y):
            return False
        if not torch.is_tensor(x):
            if x != y:
                return False
            continue
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.dtype.is_floating_point:
            x = x.reshape(-1).contiguous().view(torch.uint8)
            y = y.reshape(-1).contiguous().view(torch.uint8)
        if not torch.equal(x, y):
            return False
    return True


class OpRecorder:
    """While active, records every call of the named port functions
    (`(module under denseslam_tpu_torch.ops, name)` pairs): its inputs
    and output copied to the host, and the `frame` it was made in.
    `recheck()` recomputes each call on the CPU from its inputs."""

    def __init__(self, names, frames=None):
        self.names = names
        self.frames = frames             # record calls of frames < this
        self.frame = 0
        self.calls = []
        self._orig = {}

    def __enter__(self):
        for mod_name, fn_name in self.names:
            mod = importlib.import_module(f"denseslam_tpu_torch.ops.{mod_name}")
            fn = getattr(mod, fn_name)
            self._orig[(mod_name, fn_name)] = (mod, fn)

            def wrapped(*a, _fn=fn, _key=f"{mod_name}.{fn_name}", **kw):
                out = _fn(*a, **kw)
                if self.frames is None or self.frame < self.frames:
                    self.calls.append((_key, self.frame, _to(a, "cpu"),
                                       _to(kw, "cpu"), _to(out, "cpu")))
                return out

            setattr(mod, fn_name, wrapped)
        return self

    def __exit__(self, *exc):
        for (_, fn_name), (mod, fn) in self._orig.items():
            setattr(mod, fn_name, fn)

    def recheck(self) -> dict:
        """{function: {calls, equal, first_frame_unequal}}."""
        fns = {f"{m}.{n}": fn for (m, n), (_, fn) in self._orig.items()}
        rec = {}
        for key, frame, a, kw, out in self.calls:
            r = rec.setdefault(key, dict(calls=0, equal=0,
                                         first_frame_unequal=None))
            r["calls"] += 1
            if same_bits(fns[key](*a, **kw), out):
                r["equal"] += 1
            elif r["first_frame_unequal"] is None:
                r["first_frame_unequal"] = frame
        return rec


def golden_inputs(frames: int = FRAMES):
    """The drift golden's config, ground truth and, made on the CPU, its
    frames and RANSAC draws (chip_smoke.py `run_vo_drift`'s recipe)."""
    from denseslam_tpu_torch.config import (StereoConfig, TsdfConfig,
                                            tiny_test_config)
    from denseslam_tpu_torch.io import synthetic
    from denseslam_tpu_torch.utils import threefry
    from denseslam_tpu_torch.utils.camera import Intrinsics, StereoRig

    w, h = 1226, 370
    intr = Intrinsics(fx=707.09, fy=707.09, cx=(w - 1) / 2.0,
                      cy=(h - 1) / 2.0, width=w, height=h)
    cfg = dataclasses.replace(
        tiny_test_config(), rig=StereoRig(intr=intr, baseline_m=0.537),
        tsdf=TsdfConfig(table_slots=1 << 10),
        stereo=StereoConfig(max_disparity=64))
    gt_full = synthetic.make_loop_trajectory(500, radius_m=18.0,
                                             closure_frames=44)
    scene = synthetic.loop_scene(gt_full)
    gt = gt_full[:frames]
    cpu = torch.device("cpu")
    k = cfg.frontend.ransac_iters
    noise_key = threefry.prng_key(0, cpu)
    vo_key = threefry.prng_key(0, cpu)
    lefts, rights, draws = [], [], []
    for base in range(0, frames, 16):
        hi = min(base + 16, frames)
        lg, rg, _ = synthetic.render_stereo_trajectory(gt[base:hi], cfg.rig,
                                                       scene, device=cpu)
        for i in range(hi - base):
            t = base + i
            fi = torch.tensor(float(t), dtype=torch.float32)
            g = 1.0 + 0.15 * torch.sin(2 * math.pi * fi / 150.0)
            kl, kr = threefry.split(threefry.fold_in(noise_key, t))
            lefts.append(torch.clamp(lg[i] * g + 2.0 * threefry.normal(
                kl, (h, w)), 0, 255))
            rights.append(torch.clamp(rg[i] * g + 2.0 * threefry.normal(
                kr, (h, w)), 0, 255))
            vo_key, sub = threefry.split(vo_key)
            draws.append(threefry.randint(sub, (k, 3), 0, 2 ** 31 - 1))
    return cfg, gt, torch.stack(lefts), torch.stack(rights), torch.stack(draws)


def vo_drive(cfg, lefts, rights, draws, device, recorder=None):
    """Open-loop vo_step over the frames on `device`; (N, 4, 4) float64
    poses on the host."""
    from denseslam_tpu_torch.models import frontend

    state = frontend.init_frontend(cfg, device=device)
    est = []
    for t in range(lefts.shape[0]):
        if recorder is not None:
            recorder.frame = t
        state, out = frontend.vo_step(state, lefts[t].to(device),
                                      rights[t].to(device), cfg,
                                      raw=draws[t].to(device))
        est.append(out.T_wc.cpu().double())
    return torch.stack(est)


def _drift(est, gt) -> dict:
    from denseslam_tpu_torch.eval import traj_metrics

    est = [T for T in est.numpy()]
    gtl = [gt[i] for i in range(len(est))]
    kitti = traj_metrics.kitti_sequence_errors(est, gtl, lengths=(10, 15))
    path_m = float(np.sum(np.linalg.norm(np.diff(
        np.stack([T[:3, 3] for T in gtl]), axis=0), axis=1)))
    end = float(np.linalg.norm(est[-1][:3, 3] - gtl[-1][:3, 3]))
    return dict(t_err_pct=kitti["kitti_t_err_pct"],
                end_pct=end / path_m * 100.0)


def trace_vo(frames: int, recheck_frames: int) -> dict:
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg, gt, lefts, rights, draws = golden_inputs(frames)
    make_s = time.perf_counter() - t0
    with OpRecorder(TRACED, recheck_frames) as rec:
        card = vo_drive(cfg, lefts, rights, draws, dev, rec)
    t1 = time.perf_counter()
    cpu = vo_drive(cfg, lefts, rights, draws, torch.device("cpu"))
    cpu_s = time.perf_counter() - t1
    dpos = (card[:, :3, 3] - cpu[:, :3, 3]).norm(dim=1)
    bits = [i for i in range(frames) if not same_bits(card[i], cpu[i])]
    parted = torch.nonzero(dpos > PART_M).flatten().tolist()
    ops = rec.recheck()
    return dict(mode="vo", frames=frames, recheck_frames=recheck_frames,
                first_frame_any_bit=bits[0] if bits else None,
                first_frame_parted=parted[0] if parted else None,
                part_m=PART_M, max_pos_diff_m=float(dpos.max()),
                pos_diff_m=[float(x) for x in dpos],
                card=_drift(card, gt), cpu=_drift(cpu, gt), ops=ops,
                make_s=make_s, cpu_drive_s=cpu_s,
                recheck_s=time.perf_counter() - t1 - cpu_s)


def drive_window():
    """The flagship drive's first local BA window, built by the port's
    Backend on the CPU: its BAProblem and config."""
    from denseslam_tpu_torch.config import SystemConfig
    from denseslam_tpu_torch.io import synthetic
    from denseslam_tpu_torch.models import backend
    from denseslam_tpu_torch.ops import features
    from denseslam_tpu_torch.utils.camera import Intrinsics, StereoRig

    w, h = 1226, 370
    intr = Intrinsics(fx=707.09, fy=707.09, cx=(w - 1) / 2.0,
                      cy=(h - 1) / 2.0, width=w, height=h)
    cfg = SystemConfig(rig=StereoRig(intr=intr, baseline_m=0.537))
    frames = (0, 4, 8, 12)
    gt = synthetic.make_loop_trajectory(500, radius_m=18.0,
                                        closure_frames=76)
    scene = synthetic.loop_scene(gt)
    poses = gt[list(frames)].astype(np.float32)
    lefts, rights, _ = synthetic.render_stereo_trajectory(
        poses, cfg.rig, scene, device="cpu")
    rng = np.random.default_rng(6)
    t = torch.tensor(frames, dtype=torch.float32)
    gain = (1.0 + 0.15 * torch.sin(2 * math.pi * t / 150.0))[:, None, None]
    imgs = [torch.clamp(x * gain + 2.0 * torch.tensor(
        rng.standard_normal(tuple(x.shape)).astype(np.float32)), 0, 255)
        for x in (lefts, rights)]
    be = backend.Backend(cfg, device="cpu")
    for i, f in enumerate(frames):
        be.add_keyframe(f, poses[i], features.detect(imgs[0][i], cfg.frontend),
                        features.detect(imgs[1][i], cfg.frontend))
    return be.window_problem()[0], cfg


def trace_ba() -> dict:
    from denseslam_tpu_torch.ops import ba

    problem, cfg = drive_window()
    runs = {}
    for name, device, dtype in (("card", "cuda", torch.float32),
                                ("cpu", "cpu", torch.float32),
                                ("oracle_f64", "cpu", torch.float64)):
        p = type(problem)(*[x.to(device, dtype) if x.is_floating_point()
                            else x.to(device) for x in problem])
        steps = []
        res = ba.solve(p, cfg.rig, cfg.backend, steps=steps)
        runs[name] = dict(T=res.T_wc.cpu().double(),
                          steps=[bool(s) for s in steps],
                          final_cost=float(res.final_cost))
    o = runs["oracle_f64"]["T"]

    def dist(a, b):
        return [float(x) for x in (a[:, :3, 3] - b[:, :3, 3]).norm(dim=1)]

    card, cpu = runs["card"], runs["cpu"]
    return dict(mode="ba", keyframes=int(problem.T_wc.shape[0]),
                observations=int(problem.obs_mask.sum()),
                card_to_oracle_m=dist(card["T"], o),
                cpu_to_oracle_m=dist(cpu["T"], o),
                card_to_cpu_m=dist(card["T"], cpu["T"]),
                steps={k: v["steps"] for k, v in runs.items()},
                steps_differ_card_cpu=[i for i, (a, b) in enumerate(zip(
                    card["steps"], cpu["steps"])) if a != b],
                final_cost={k: v["final_cost"] for k, v in runs.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["vo", "ba"])
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--recheck-frames", type=int, default=24,
                    help="vo: recompute the traced calls of these first "
                    "frames on the CPU")
    ap.add_argument("--json", default=None,
                    help="default build/device_trace_<mode>.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("device_trace: no CUDA device is available", file=sys.stderr)
        return 1
    rec = (trace_vo(args.frames, args.recheck_frames) if args.mode == "vo"
           else trace_ba())
    out = args.json or os.path.join(ROOT, "build",
                                    f"device_trace_{args.mode}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    rec.pop("pos_diff_m", None)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
