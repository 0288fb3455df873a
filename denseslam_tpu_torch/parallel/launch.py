"""Multi-process launch: torch.distributed initialisation and the global
map axis (port of denseslam_tpu/parallel/launch.py).

One process per card. Every process calls `init_distributed` before its
first device use, then builds the same map axis (`global_map_mesh`); the
sharded map (parallel/sharded_map.py) runs unchanged on it. Under torchrun
the arguments come from its environment:

    torchrun --nproc_per_node 4 -m denseslam_tpu_torch.tools.bench_scaling

Nothing on a machine tells a process of its cluster otherwise: give the
coordinator's `host:port`, the process count and this process's id.

The backend is explicit: NCCL between cards; gloo only when the caller
asks for it (`backend="gloo"`, as on the CPU, or for ranks that share one
card). A failed NCCL initialisation raises; gloo is never a fallback.
Ranks run on `cuda:LOCAL_RANK` unless the caller names a device (or
"cpu").
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

_state = {"device": None}


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device=None) -> int:
    """Initialise the process group; returns this process's rank.

    A single process (no arguments and no torchrun environment) is a
    no-op that returns 0, so every entry point can call this. The
    arguments default to torchrun's MASTER_ADDR:MASTER_PORT, WORLD_SIZE and
    RANK; the device to cuda:LOCAL_RANK (LOCAL_RANK defaults to the rank).
    `backend` defaults to "nccl", or "gloo" when `device` is the CPU."""
    env = os.environ
    # under torchrun its agent already serves the store at MASTER_PORT:
    # join it through the environment rather than by address
    init_method = f"tcp://{coordinator}" if coordinator else "env://"
    if coordinator is None and "MASTER_ADDR" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator is None and num_processes is None:
        return 0                          # single-process mode
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the coordinator, the "
                         "process count and this process's id")
    if device is None:
        device = f"cuda:{int(env.get('LOCAL_RANK', process_id))}"
    device = torch.device(device)
    if backend is None:
        backend = "gloo" if device.type == "cpu" else "nccl"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend=backend, init_method=init_method,
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=600))
    _state["device"] = device
    return dist.get_rank()


def shutdown_distributed() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _state["device"] = None


def local_device() -> torch.device:
    """This rank's device as `init_distributed` chose it; before that (a
    single process) the CUDA card, which raises where there is none."""
    d = _state["device"]
    return d if d is not None else resolve_device(None)


def global_map_mesh(device=None):
    """The map axis over every process (parallel/mesh.py `MapMesh`). Call
    after `init_distributed`; a single process gets a mesh of size 1 on
    `device` (default the CUDA card; "cpu" only when asked for)."""
    from .mesh import make_map_mesh
    return make_map_mesh(device=device)


def is_coordinator() -> bool:
    return (not dist.is_available() or not dist.is_initialized()
            or dist.get_rank() == 0)


def _local_rank(local, fn, nprocs, coordinator, backend, device, args,
                results, nnodes, node_rank):
    init_distributed(coordinator, nprocs * nnodes, node_rank * nprocs + local,
                     backend=backend,
                     device=f"cuda:{local}" if device is None else device)
    try:
        results.put((local, fn(global_map_mesh(), *args)))
    finally:
        shutdown_distributed()


def run_local(fn, nprocs: int, *args, backend: Optional[str] = None,
              device=None, coordinator: Optional[str] = None,
              nnodes: int = 1, node_rank: int = 0) -> list:
    """Run `fn(mesh, *args)` in `nprocs` spawned processes of this host,
    one rank each over `backend` (default NCCL, gloo for the CPU) on
    `device`: None for cuda:LOCAL_RANK, "cuda:0" for ranks that share one
    card, "cpu" for the CPU. Returns this host's ranks' results
    (picklable; tensors on the host) in rank order. A rank that fails
    fails the run. Several hosts (or launchers of one host) join as
    `nnodes` groups of `nprocs` ranks: each calls this with the same
    `coordinator` ("host:port" of node 0) and its own `node_rank`."""
    import socket
    import torch.multiprocessing as mp

    if coordinator is None:
        if nnodes != 1:
            raise ValueError("ranks of several nodes need a coordinator")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(_local_rank, args=(fn, nprocs, coordinator,
                                                backend, device, args,
                                                results, nnodes, node_rank),
                             nprocs=nprocs, start_method="spawn", join=False)
    out, done = {}, False
    # drain while the ranks run: a large result fills the pipe, and its
    # rank exits only once it is read; join raises if a rank failed
    while len(out) < nprocs:
        while not results.empty():
            rank, res = results.get()
            out[rank] = res
        if done and len(out) < nprocs and results.empty():
            raise RuntimeError("a rank exited without a result")
        if not done:
            done = ctx.join(timeout=0.05)
    while not ctx.join():
        pass
    return [out[r] for r in range(nprocs)]
