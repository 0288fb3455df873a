"""Make the JAX golden of the stereo main path, which the port is held to.

    JAX_PLATFORMS=cpu python tests/_torch_golden.py           # 1226x370, 64 frames
    JAX_PLATFORMS=cpu python tests/_torch_golden.py --tiny    # 160x120, 8 frames

A helper script, not a test module (it imports both packages, as only
files under tests/ may). It

  1. writes the flagship loop drive's first frames as a KITTI sequence of
     8-bit PNGs with the port's io/make_dataset.py on the CPU, with
     chip_smoke.py's CLI_KITTI_ARGS (the sequence that script's
     `cli_datasets` renders on the card);
  2. decodes it with the JAX package's reader (cv2);
  3. runs the JAX package's `process_sequence`, jitted, over all frames as
     one chunk from `init_frontend` (seed 0: the RANSAC draws come from its
     key), `make_map` and `make_fusion_db`, with the stereo drive's
     configuration of scripts/long_drive_eval.py:137-172 at its defaults
     (restated here as `jax_drive_config`); on the CPU the tile sampler
     runs in Pallas interpret mode;
  4. writes the record of denseslam_tpu_torch/tools/golden.py
     (`run_record`: input, keyframe-depth and per-block map digests, the
     per-frame poses and counts) with its meta: the configuration, the
     dataset's arguments, the jax version, the commit and the files that
     make the golden where the working tree differs from it.

--tiny makes the same record at 160x120 over 8 frames with the small
variant of the configuration (the script's --cpu shrink) into
tests/golden/stereo_chunk_jax_tiny.npz, which tests/test_torch_golden.py
holds the port to on the CPU. The full golden takes about 6 minutes and
5 GB of memory on 8 CPU cores; the tiny one about 25 s. Run twice, the
generator writes equal arrays.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "golden", "stereo_chunk_jax.npz")
GOLDEN_TINY = os.path.join(HERE, "golden", "stereo_chunk_jax_tiny.npz")
TINY = dict(frames=8, width=160, height=120)


def kitti_args(tiny: bool = False) -> list:
    """chip_smoke.py's CLI_KITTI_ARGS; --tiny at 160x120 over 8 frames with
    fx scaled as the drive scales its rig."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from chip_smoke import CLI_KITTI_ARGS
    args = list(CLI_KITTI_ARGS)
    if tiny:
        for flag, v in (("--frames", TINY["frames"]),
                        ("--width", TINY["width"]),
                        ("--height", TINY["height"]),
                        ("--fx", 707.09 * TINY["width"] / 1226.0)):
            args[args.index(flag) + 1] = str(v)
    return args


def jax_drive_config(small: bool = False):
    """The JAX SystemConfig of scripts/long_drive_eval.py:137-172 for
    --sensor stereo at the script's defaults (1226x370, keyframe_every 4,
    slide max age 60, decay min age 30, one submap, no budget); `small` is
    the script's --cpu shrink at 160x120."""
    from denseslam_tpu.config import (OnlineCorrectionParams,
                                      PipelineConfig, SlideWindowParams,
                                      StereoConfig, SystemConfig,
                                      TsdfConfig, VoxelDecayParams)
    from denseslam_tpu.utils.camera import Intrinsics, StereoRig

    w, h = (TINY["width"], TINY["height"]) if small else (1226, 370)
    scale = w / 1226.0
    intr = Intrinsics(fx=707.09 * scale, fy=707.09 * scale,
                      cx=(w - 1) / 2.0, cy=(h - 1) / 2.0, width=w, height=h)
    cfg = SystemConfig(
        rig=StereoRig(intr=intr, baseline_m=0.537),
        tsdf=TsdfConfig(
            voxel_size_m=0.06, trunc_dist_m=0.24, table_slots=1 << 17,
            max_visible_blocks=1 << 13, max_alloc_per_frame=1 << 13,
            max_depth_m=40.0, sampler="pallas", alloc_subsample=2),
        stereo=StereoConfig(cost_dtype="bfloat16"),
        decay=VoxelDecayParams(enabled=True, min_decay_age=30,
                               max_decay_weight=2),
        slide_window=SlideWindowParams(enabled=True, max_age=60),
        correction=OnlineCorrectionParams(enabled=True, correction_num=5,
                                          start_correction_num=4,
                                          min_error=0.01),
        pipeline=PipelineConfig(keyframe_every=4, fusion_db_capacity=64,
                                new_submap_threshold=-1.0,
                                map_memory_budget_mb=-1.0, sensor="stereo"))
    if small:
        cfg = dataclasses.replace(
            cfg, tsdf=dataclasses.replace(
                cfg.tsdf, table_slots=1 << 14, max_visible_blocks=1 << 11,
                max_alloc_per_frame=1 << 11, sampler="gather"),
            stereo=StereoConfig(max_disparity=64))
    return cfg


def write_sequence(out: str, tiny: bool = False) -> str:
    """The KITTI sequence, rendered on the CPU by the port's make_dataset."""
    from denseslam_tpu_torch.io.make_dataset import make_dataset
    return make_dataset([out] + kitti_args(tiny) + ["--device", "cpu"])


def decode_jax(root: str):
    """(lefts, rights) float32 (N, H, W) as the JAX package's reader
    decodes them."""
    from denseslam_tpu.io import datasets
    frames = list(datasets.Input(root, datasets.kitti_odometry_config()))
    return (np.stack([f["left"] for f in frames]),
            np.stack([f["right"] for f in frames]))


def run_jax(cfg, lefts, rights):
    """JAX process_sequence over all frames as one jitted chunk; returns
    (stats, map leaves, DB leaves) as numpy."""
    import jax
    import jax.numpy as jnp

    from denseslam_tpu.models import dense_slam as jd
    from denseslam_tpu.models import frontend as jfe
    from denseslam_tpu.ops import tsdf as jt

    seq = jax.jit(lambda st, m, db, l, r, f: jd.process_sequence(
        st, m, db, l, r, f, cfg))
    fids = jnp.arange(lefts.shape[0], dtype=jnp.int32)
    _, m, db, stats = seq(jfe.init_frontend(cfg, seed=0),
                          jt.make_map(cfg.tsdf), jd.make_fusion_db(cfg),
                          jnp.asarray(lefts), jnp.asarray(rights), fids)
    stats = {k: np.asarray(stats[k])
             for k in ("T_wc", "tracking_ok", "fused", "num_inliers")}
    return (stats, [np.asarray(x) for x in jax.tree.leaves(m)],
            [np.asarray(x) for x in jax.tree.leaves(db)])


def make_golden(out: str, tiny: bool = False, workdir: str | None = None):
    """Write the golden record into `out`; returns (record, meta)."""
    import jax

    from denseslam_tpu_torch.tools import golden

    cfg = jax_drive_config(small=tiny)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        lefts, rights = decode_jax(write_sequence(
            os.path.join(tmp, "kitti"), tiny))
    rec = golden.run_record(*run_jax(cfg, lefts, rights),
                            golden.input_digest(lefts, rights))
    git = lambda *a: subprocess.run(  # noqa: E731
        ["git", *a], cwd=ROOT, capture_output=True, text=True).stdout
    # the files that make the golden, where they differ from the commit
    changed = git("status", "--porcelain", "--", "denseslam_tpu",
                  "denseslam_tpu_torch/io", "tests/_torch_golden.py",
                  "chip_smoke.py").splitlines()
    meta = dict(config=golden.config_json(cfg), kitti_args=kitti_args(tiny),
                tiny=tiny, jax_version=jax.__version__,
                commit=git("rev-parse", "HEAD").strip() or None,
                changed_from_commit=sorted(changed),
                frames=int(lefts.shape[0]))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    golden.save(out, rec, meta)
    return rec, meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true",
                    help="160x120 over 8 frames, the small configuration")
    ap.add_argument("--out", default=None,
                    help="the record's path (default tests/golden/...)")
    ap.add_argument("--workdir", default=None,
                    help="where the PNG sequence is written for the run "
                    "(a temporary directory inside it)")
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    out = args.out or (GOLDEN_TINY if args.tiny else GOLDEN)
    rec, meta = make_golden(out, args.tiny, args.workdir)
    print(dict(out=out, bytes=os.path.getsize(out), frames=meta["frames"],
               fused=int(rec["fused"].sum()),
               tracking=int(rec["tracking_ok"].sum()),
               blocks=int(len(rec["block_slot"])),
               counters=rec["map_counters"].tolist()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
