"""PyTorch / CUDA port of `denseslam_tpu`.

The JAX package beside this one is the reference: every function here is
held against its JAX counterpart on the same inputs (tests/test_torch_*.py).
This package imports neither `jax` nor `denseslam_tpu`; it keeps its own
copies of what it needs.

Layer map (the ported slices):
  config.py         — the configuration dataclasses (same fields, defaults)
  utils/            — camera model, SE(3) helpers, one-rounding division
  ops/hash.py       — packed-key open-addressing voxel-block table
  ops/sampling.py   — fusion image samplers (csrc/tile_sample.cu: B1, B2)
  ops/tsdf.py       — allocate / integrate / decay / slide window
  ops/sgm.py        — SGM path aggregation (csrc/sgm.cu) and its fused
                      last direction + WTA tail (csrc/sgm_final.cu)
  ops/stereo.py     — ZSAD cost volume, WTA, LR check, depth
  ops/features.py, matching.py, ransac.py, smallsolve.py — the sparse VO
  ops/ba.py, posegraph.py — bundle adjustment and pose-graph relaxation
  models/frontend.py — VO state machine: vo_step (stereo), rgbd_vo_step
  models/dense_slam.py — fusion DB, fuse_keyframe, fuse_sequence,
                      process_sequence (stereo), process_sequence_rgbd,
                      online correction, DenseSLAM (one submap)
  models/backend.py — keyframes, local BA, culling, loop closure
  models/system.py  — SLAMSystem: the chunk scan + one backend tick a chunk
  main.py           — the command line (python -m denseslam_tpu_torch.main)
  io/datasets.py    — dataset reader; io/png.py, pfm.py, native.py codecs
  io/trajectory.py, checkpoint.py — trajectories; the JAX checkpoint layout
  io/synthetic.py   — analytic street scene renderer (test and smoke input);
                      io/make_dataset.py writes it as a KITTI / TUM sequence
  io/convert.py     — JAX-package state (as numpy) <-> port state
  utils/timing.py   — Tic/Toc timers on CUDA events
  eval/             — depth-vs-GT and trajectory metrics (numpy)
  kernels.py        — nvcc build of csrc/ at first use, ctypes bindings

Numerics: the JAX package pins f32 "highest" matmul precision, so TF32 is
turned off here for both matmuls and cuDNN convolutions.
"""

import torch as _torch

__version__ = "0.1.0"

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
