"""What the experiment tools share: in-process runs of the command line."""

from __future__ import annotations

import gc
from typing import List, Optional

import torch


def device_args(device: Optional[str]) -> List[str]:
    """`--device DEVICE` when one is named, else nothing (the card)."""
    return ["--device", device] if device else []


def run_main(argv: List[str], device: Optional[str] = None) -> int:
    """One run of the command line (denseslam_tpu_torch.main.main) in this
    process with `argv` and `--device`, then its map freed: a sweep runs
    several maps of 2^17 slots in turn on one card, so each run's tensors
    are collected and the allocator's cache emptied before the next."""
    from .. import main as cli

    rc = cli.main(argv + device_args(device))
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return rc
