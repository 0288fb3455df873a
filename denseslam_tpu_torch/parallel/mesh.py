"""The map axis over torch.distributed (port of
denseslam_tpu/parallel/mesh.py).

JAX shards the map over a 1-D device mesh inside one program. Here each
card is one process (launched by torchrun, parallel/launch.py), and the
counterpart of the mesh is `MapMesh`: the process group, this process's
rank, the group's size and this rank's device, with the collectives the
sharded map needs (JAX's `psum` / `pmin` / `pmax` become `all_reduce`
SUM / MIN / MAX, its `all_to_all` becomes `all_to_all_single`).

`map_sharding` and `replicated` have no counterpart: a process holds its
own shard as ordinary tensors, and what JAX replicates every rank simply
holds whole, so there is no sharding object to make.

Backends: NCCL between cards; gloo on the CPU, and for several ranks that
share one card. Gloo's collectives are not all defined on CUDA tensors
(all_to_all is not), so under gloo with a card every collective of this
wrapper is staged through the host: copied to the CPU, reduced there and
copied back. A mesh of size 1 runs every collective as the identity and
needs no process group.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

MAP_AXIS = "map"

_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


class MapMesh:
    """One rank's view of the 1-D map axis: `group` (None = the default
    process group), `rank`, `size` and `device` (None = the CUDA card,
    device.py `resolve_device`; "cpu" only when asked for)."""

    def __init__(self, group=None, rank: int = 0, size: int = 1,
                 device=None, backend: Optional[str] = None):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = resolve_device(device)
        self.backend = backend
        # gloo on a card: every collective goes through the host
        self.stage_on_host = (backend == "gloo"
                              and self.device.type == "cuda")

    def __repr__(self) -> str:
        return (f"MapMesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend})")

    def _to_comm(self, x: torch.Tensor) -> torch.Tensor:
        return x.cpu() if self.stage_on_host else x

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A new tensor: `x` reduced over the ranks by `op` (sum, min or
        max)."""
        if self.size == 1:
            return x.clone()
        # NCCL takes contiguous tensors only (an einsum's result may be a
        # permuted view, and clone keeps its strides)
        y = self._to_comm(x).clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=getattr(dist.ReduceOp, _OPS[op]),
                        group=self.group)
        return y.to(x.device)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(size, ...) -> (size, ...): row d goes to rank d, and row d of
        the result came from rank d (JAX's `all_to_all` with split and
        concat axis 0)."""
        if self.size == 1:
            return x.clone()
        src = self._to_comm(x).contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return out.to(x.device)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `x` on every rank (a new tensor on x's device)."""
        if self.size == 1:
            return x
        y = self._to_comm(x).clone(memory_format=torch.contiguous_format)
        dist.broadcast(y, src=src, group=self.group)
        return y.to(x.device)

    def broadcast_object(self, obj, src: int = 0):
        """Rank `src`'s picklable `obj` (host values) on every rank."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(
            box, src=src, group=self.group,
            device=None if self.stage_on_host or self.device.type != "cuda"
            else self.device)
        return box[0]

    def all_gather_rows(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's `x` (n_r, ...), n_r free per rank, in rank order."""
        if self.size == 1:
            return [x]
        n = self._to_comm(torch.tensor([x.shape[0]], dtype=torch.int64,
                                       device=x.device))
        ns = [torch.empty_like(n) for _ in range(self.size)]
        dist.all_gather(ns, n, group=self.group)
        ns = [int(v) for v in ns]
        top = max(max(ns), 1)
        pad = torch.zeros((top,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        pad[:x.shape[0]] = x
        pad = self._to_comm(pad)
        parts = [torch.empty_like(pad) for _ in range(self.size)]
        dist.all_gather(parts, pad, group=self.group)
        return [p[:k].to(x.device) for p, k in zip(parts, ns)]

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


def make_map_mesh(group=None, device=None) -> MapMesh:
    """The map axis over the process group `group` (None = the default
    group, or a single process when torch.distributed is not initialised),
    this rank on `device` (default: parallel/launch.py's device for this
    rank; in a single process the CUDA card, which raises where there is
    none: pass "cpu" to run on the CPU)."""
    if not dist.is_available() or not dist.is_initialized():
        return MapMesh(device=device)
    from . import launch
    if device is None:
        device = launch.local_device()
    return MapMesh(group=group, rank=dist.get_rank(group),
                   size=dist.get_world_size(group), device=device,
                   backend=dist.get_backend(group))
