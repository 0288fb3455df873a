"""Keyframe backend (port of part of denseslam_tpu/models/backend.py): only
the per-frame retrieval sketch that `process_sequence_rgbd` emits. Local
BA, loop detection and the pose graph come with ROADMAP.md Queue A, A6."""

from __future__ import annotations

import torch

from ..ops.features import Features

_SIG_M = 256     # descriptors retained per keyframe sketch


def signature_device(feats: Features) -> torch.Tensor:
    """Place-recognition sketch: the _SIG_M strongest valid descriptors,
    unit-normalised, as an (_SIG_M, D) matrix (rows zero when absent).
    Ties in score keep the lower index, as `lax.top_k` does."""
    k = min(_SIG_M, feats.score.shape[0])
    s = torch.where(feats.valid, feats.score, float("-inf"))
    idx = torch.sort(s, descending=True, stable=True).indices[:k]
    d = feats.desc[idx]
    ok = feats.valid[idx]
    n = torch.sqrt((d * d).sum(dim=1, keepdim=True))
    d = torch.where(n > 1e-6, d / torch.clamp(n, min=1e-6), 0.0) * ok[:, None]
    if k < _SIG_M:
        d = torch.nn.functional.pad(d, (0, 0, 0, _SIG_M - k))
    return d.to(torch.float32)
