"""Named Tic/Toc timer stack + telemetry (port of
denseslam_tpu/utils/timing.py; the reference's `utils::Tic/Toc`,
src/DenseSLAM/Utils.h:100-248).

The JAX version's `toc` blocks until its `sync` arrays are ready, so that
an interval covers the device work. Here an interval of card work is
timed by two CUDA events recorded on the current stream, and read only
when `mean_ms`, `last_ms`, `report` or a `Lap`'s `ms` asks: timing adds no host
sync to the path it times. An interval is timed on the card when CUDA is
initialised at `tic` and the `sync` tensor handed to `toc` (if any) lies
on the card; otherwise by `time.perf_counter` on the host. `scope()`
also opens a `torch.profiler.record_function` of its name, the
counterpart of `jax.profiler.TraceAnnotation`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch


class Lap:
    """One timed interval: host milliseconds, or a pair of CUDA events
    read (once) on demand."""

    __slots__ = ("_ms", "_events")

    def __init__(self, ms: Optional[float] = None, events=None):
        self._ms = ms
        self._events = events

    def ready(self) -> bool:
        """True when reading `ms` would not wait for the card."""
        return self._ms is not None or self._events[1].query()

    def ms(self) -> float:
        if self._ms is None:
            start, end = self._events
            if not end.query():     # a wait only where the card is behind
                end.synchronize()
            self._ms = float(start.elapsed_time(end))
            self._events = None
        return self._ms


def _on_cuda(x) -> bool:
    """Whether `x` (a tensor, or a list / tuple / dict of them) holds a
    tensor on a CUDA device."""
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return any(_on_cuda(v) for v in x)
    return False


class TimerStack:
    """LIFO named timers, ms resolution, with running means."""

    def __init__(self) -> None:
        self._stack: List[Tuple[str, float, object]] = []
        self._laps: Dict[str, List[Lap]] = {}
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self.silent = True

    def tic(self, name: str) -> None:
        start = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        self._stack.append((name, time.perf_counter(), start))

    def toc(self, name: str | None = None,
            sync: object = None) -> Optional[float]:
        """Pop the top timer. Returns its elapsed milliseconds when it was
        timed on the host; an interval timed on the card is read later
        (returns None).

        `sync`: the tensor(s) the interval produced; on the CPU, the
        interval is timed on the host.
        """
        if not self._stack:
            raise RuntimeError("Timers::toc with empty stack")
        top_name, t0, start = self._stack.pop()
        if name is not None and name != top_name:
            raise RuntimeError(f"Timer mismatch: expected {top_name}, got {name}")
        if start is not None and (sync is None or _on_cuda(sync)):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            lap = Lap(events=(start, end))
        else:
            lap = Lap(ms=(time.perf_counter() - t0) * 1000.0)
        laps = self._laps.setdefault(top_name, [])
        laps.append(lap)
        self._counts[top_name] = self._counts.get(top_name, 0) + 1
        self._fold(top_name)
        if lap._ms is None:
            return None
        if not self.silent:
            print(f"[timer] {top_name}: {lap._ms:.2f} ms")
        return lap._ms

    def last_lap(self, name: str) -> Lap:
        return self._laps[name][-1]

    def _fold(self, name: str, wait: bool = False) -> None:
        """Add the leading laps of `name` that are read (or ready, or all
        of them with `wait`) into its total, keeping the last one."""
        laps = self._laps[name]
        n = 0
        while n < len(laps) - 1 and (wait or laps[n].ready()):
            self._totals[name] = self._totals.get(name, 0.0) + laps[n].ms()
            n += 1
        del laps[:n]

    def _total(self, name: str) -> float:
        self._fold(name, wait=True)
        return self._totals.get(name, 0.0) + self._laps[name][-1].ms()

    @contextlib.contextmanager
    def scope(self, name: str, sync_fn=None):
        self.tic(name)
        with torch.profiler.record_function(name):
            result = {}
            try:
                yield result
            finally:
                self.toc(name, sync=result.get("sync"))

    def mean_ms(self, name: str) -> float:
        c = self._counts.get(name, 0)
        return self._total(name) / c if c else 0.0

    def last_ms(self, name: str) -> float:
        laps = self._laps.get(name)
        return laps[-1].ms() if laps else 0.0

    def report(self) -> str:
        lines = []
        for name in sorted(self._counts):
            total = self._total(name)
            lines.append(
                f"{name:32s} mean {total / self._counts[name]:9.3f} ms  "
                f"n={self._counts[name]:5d}  total {total:10.1f} ms"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self._stack.clear()
        self._laps.clear()
        self._totals.clear()
        self._counts.clear()


TIMERS = TimerStack()


def tic(name: str) -> None:
    TIMERS.tic(name)


def toc(name: str | None = None, sync: object = None) -> Optional[float]:
    return TIMERS.toc(name, sync=sync)
