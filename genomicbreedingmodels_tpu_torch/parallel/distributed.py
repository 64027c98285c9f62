"""Multi-process start-up and the hybrid mesh, torch port of
genomicbreedingmodels_tpu/parallel/distributed.py.

Scale-out recipe (BASELINE's north star, 100k x 1M panels over many cards):
1. Start one process per card, e.g. on each of H hosts with G cards
   `torchrun --nnodes H --nproc-per-node G --rdzv-endpoint HOST0:29500 prog.py`
   (torchrun sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT),
   and call `distributed_init()` in every process.
2. `make_multihost_mesh()`: 'mp' (markers) spans the cards of one host
   (NVLink), 'dp' (folds, chains, traits) spans hosts, so the heavy Gram and
   effect all-reduces stay within a host and only job-level reductions cross
   the network.
3. Each process loads only its own marker range (`process_local_panel_slice`)
   or passes the global panel and lets the sharded functions upload its shard.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

__all__ = ["distributed_init", "make_multihost_mesh", "process_local_panel_slice"]


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    timeout: float = 600.0,
) -> bool:
    """Initialise the default process group if a multi-process environment
    is detected or configured; return True when running multi-process.

    The coordinator is `coordinator_address` ("host:port"), else
    `GBM_COORDINATOR` (as the JAX twin reads it), else torchrun's
    MASTER_ADDR:MASTER_PORT; the world size and rank are the arguments, else
    WORLD_SIZE and RANK. `init_method` (e.g. "file:///path") replaces the
    TCP coordinator. `backend` defaults to NCCL when CUDA is usable, gloo
    otherwise. A single-process run (no coordinator, or a world of one) is a
    no-op returning False, so library code can call it unconditionally.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if init_method is None:
        addr = coordinator_address or env.get("GBM_COORDINATOR")
        if addr is None and env.get("MASTER_ADDR"):
            addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        if addr is None:
            return False
        init_method = f"tcp://{addr}"
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if world <= 1:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return True


def make_multihost_mesh(
    axis_names: Tuple[str, str] = ("dp", "mp"),
    dp_per_host: int = 1,
    devices=None,
) -> Mesh:
    """Hybrid mesh: 'mp' = the cards of one host, 'dp' = hosts times an
    optional split of each host's cards.

    Hosts are counted from LOCAL_WORLD_SIZE (torchrun's processes per host;
    ranks of one host are consecutive). Single process: a (1, 1) mesh, so the
    same model code runs everywhere."""
    if not dist.is_initialized():
        return make_mesh((1, 1), axis_names, devices)
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local:
        raise ValueError(f"LOCAL_WORLD_SIZE={local} does not divide the world size {world}")
    if local % dp_per_host:
        raise ValueError(f"dp_per_host={dp_per_host} does not divide the {local} ranks of a host")
    mp = local // dp_per_host
    return make_mesh((world // mp, mp), axis_names, devices)


def process_local_panel_slice(n_markers_global: int) -> Tuple[int, int]:
    """[start, stop) marker range this process should load (a contiguous
    split by rank), to pair with `io.read_bed` column slicing so that each
    process touches only its part of a huge panel. (0, n) single-process."""
    from .mesh import shard_range

    if not dist.is_initialized():
        return 0, int(n_markers_global)
    return shard_range(n_markers_global, dist.get_world_size(), dist.get_rank())
