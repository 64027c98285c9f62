"""The ('dp', 'mp') rank mesh over `torch.distributed`, torch port of
genomicbreedingmodels_tpu/parallel/mesh.py.

The JAX package shards the marker dimension p over 'mp' and batches
independent work (CV folds, chains, traits) over 'dp' with `shard_map` on a
device mesh that one controller drives. The port runs SPMD: one rank per
card, as `torchrun` starts it (NCCL across cards, gloo on the CPU), every
rank calling the same function with the same global arguments. A `Mesh` is
this rank's view of the grid: the axis sizes (`mesh.shape[axis]`, as the JAX
code reads them), its coordinates, its device, and one process group per
axis (plus one over all ranks).

Every collective goes through those group objects' own methods
(`pg.allreduce`, `pg.broadcast`, `pg.allgather`), never through the default
group, so a mesh can also be built from groups made inside one process:
`run_ranks` runs `fn(mesh)` once per rank as threads of this process over
gloo groups on one in-memory store, the counterpart of the JAX package's
virtual CPU device mesh (`--xla_force_host_platform_device_count`). On one
card its ranks share the card and the host stages every gloo collective of
a CUDA tensor, so its times are not interconnect times.

A collective that waits on a rank which has failed does not block: thread
ranks poll an abort flag while their gloo work is pending, so one rank's
exception fails every rank at once and `run_ranks` re-raises it.
"""

from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["Mesh", "RankAborted", "fold_share", "make_mesh", "marker_sharding", "replicated",
           "run_ranks", "shard_range"]

# Groups of a run whose ranks failed: a gloo group with work still pending
# joins its worker threads when it is destroyed, which would block until the
# group's timeout, so such groups are kept alive instead of dropped.
_ABANDONED: list = []


class RankAborted(RuntimeError):
    """Raised in a rank whose collective was cut because another rank failed."""


class Mesh:
    """This rank's view of a ('dp', 'mp') grid of ranks.

    `shape` maps axis name to size; `coords` maps axis name to this rank's
    index along it; `groups[axis]` is the process group of the ranks that
    share every other coordinate (`groups[None]` spans all ranks). Rank r of
    a (dp, mp) mesh sits at (r // mp, r % mp)."""

    def __init__(self, axis_names: Tuple[str, str], sizes: Tuple[int, int], rank: int,
                 groups: Dict, device: torch.device, backend: str,
                 abort: Optional[threading.Event] = None) -> None:
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.rank = int(rank)
        self.coords = {self.axis_names[0]: rank // sizes[1], self.axis_names[1]: rank % sizes[1]}
        self.groups = groups
        self.device = device
        self.backend = backend
        self._abort = abort

    @property
    def size(self) -> int:
        return self.shape[self.axis_names[0]] * self.shape[self.axis_names[1]]

    def axis_size(self, axis: Optional[str]) -> int:
        return self.size if axis is None else self.shape[axis]

    def index(self, axis: Optional[str]) -> int:
        return self.rank if axis is None else self.coords[axis]

    # -- collectives (through the group even for one rank: a one-rank NCCL
    # group still runs NCCL) --------------------------------------------------

    def _wait(self, work) -> None:
        if self._abort is None or self.backend != "gloo":
            work.wait()
            return
        while not work.is_completed():
            if self._abort.is_set():
                raise RankAborted(f"rank {self.rank}: another rank failed")
            time.sleep(5e-5)
        work.wait()  # raises the collective's own error, if it had one

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """`t` where this mesh's backend takes it: the host for gloo (the
        copy is the staging a gloo collective of a CUDA tensor does anyway),
        the card for NCCL."""
        if self.backend == "gloo" and t.device.type != "cpu":
            return t.cpu()
        if self.backend == "nccl" and t.device.type != "cuda":
            return t.to(self.device)
        return t.contiguous()

    def allreduce(self, t: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """Sum of `t` over the ranks of `axis` (all ranks when None), as a new
        tensor on t's device. Every rank receives the same bits."""
        buf = self._staged(t)
        buf = buf.clone() if buf is t else buf
        self._wait(self.groups[axis].allreduce([buf]))
        return buf.to(t.device)

    def broadcast(self, t: torch.Tensor, axis: Optional[str] = None, root: int = 0) -> torch.Tensor:
        """Rank `root`'s `t` (root indexed along `axis`) on every rank of
        `axis`, as a new tensor on t's device."""
        buf = self._staged(t)
        buf = buf.clone() if buf is t else buf
        opts = dist.BroadcastOptions()
        opts.rootRank = int(root)
        self._wait(self.groups[axis].broadcast([buf], opts))
        return buf.to(t.device)

    def allgather(self, t: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """Every rank's `t` (same shape on all) concatenated along dim 0 in
        the order of their index along `axis`, on t's device."""
        buf = self._staged(t)
        outs = [[torch.empty_like(buf) for _ in range(self.axis_size(axis))]]
        self._wait(self.groups[axis].allgather(outs, [buf]))
        return torch.cat(outs[0]).to(t.device)

    def barrier(self) -> None:
        self.allreduce(torch.zeros(1, device=self.device))


def shard_range(p: int, D: int, i: int) -> Tuple[int, int]:
    """[start, stop) of part i when p columns are split into D contiguous
    parts, the first p % D of them one longer."""
    k, r = divmod(int(p), int(D))
    start = i * k + min(i, r)
    return start, start + k + (1 if i < r else 0)


def fold_share(mesh: Mesh, F: int) -> Tuple[str, int, int, int]:
    """(axis, Fp, lo, hi): F independent folds spread over the mesh's largest
    axis (the first on a tie: a ('dp', 'mp') mesh with dp = 1 must still
    spread them), padded to Fp, a multiple of its size; this rank takes
    folds [lo, hi). The JAX fold dispatch's rule (cv/batched.py:187-193)."""
    axis = max(mesh.axis_names, key=lambda a: mesh.shape[a])
    D = mesh.shape[axis]
    Fp = -(-F // D) * D
    lo = mesh.coords[axis] * (Fp // D)
    return axis, Fp, lo, lo + Fp // D


def marker_sharding(mesh: Mesh, p_pad: int, axis: str = "mp") -> slice:
    """This rank's columns of an (n, p_pad) panel column-sharded over `axis`
    (p_pad a multiple of the axis size), the counterpart of the JAX
    `NamedSharding(mesh, P(None, 'mp'))`."""
    D = mesh.shape[axis]
    if p_pad % D:
        raise ValueError(f"p_pad={p_pad} is not a multiple of the {axis!r} size {D}")
    w = p_pad // D
    return slice(mesh.coords[axis] * w, (mesh.coords[axis] + 1) * w)


def replicated(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Rank 0's `t` on every rank: a value every rank then holds bit for bit."""
    return mesh.broadcast(t, None, 0)


def _indexed(device) -> torch.device:
    """`device` resolved, a CUDA device with its index ("cuda" is the current card)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _factor(shape: Optional[Tuple[int, int]], world: int) -> Tuple[int, int]:
    if shape is None:
        shape = (1, world)
    if len(shape) != 2 or shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"mesh shape must be two positive sizes, got {shape}")
    if shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {tuple(shape)} needs {shape[0] * shape[1]} ranks, "
                         f"there are {world}")
    return int(shape[0]), int(shape[1])


def _axis_members(sizes: Tuple[int, int]) -> Dict[int, List[List[int]]]:
    """For axis 0 and 1, the rank lists of its groups (ranks differing only
    along that axis), in a fixed order every rank enumerates alike."""
    dp, mp = sizes
    return {
        0: [[a * mp + c for a in range(dp)] for c in range(mp)],
        1: [[a * mp + c for c in range(mp)] for a in range(dp)],
    }


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("dp", "mp"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """This rank's ('dp', 'mp') mesh over the initialised default group.

    Every rank must call it, in the same order as its other group
    creations. Default shape: all ranks on the marker axis (1, world).
    `devices[rank]` is this rank's device; by default the CUDA card of its
    local rank (`LOCAL_RANK`, as torchrun sets it). Without an initialised
    default group the mesh is this process alone, (1, 1) over a one-rank
    gloo group."""
    if not dist.is_initialized():
        sizes = _factor(shape, 1)
        dev = _indexed(devices[0] if devices is not None else "cuda")
        return _rank_mesh(dist.HashStore(), sizes, axis_names, 0, dev, "gloo", 300.0, None)
    world, rank = dist.get_world_size(), dist.get_rank()
    sizes = _factor(shape, world)
    if devices is not None:
        dev = _indexed(devices[rank])
    else:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = resolve_device(f"cuda:{local % max(torch.cuda.device_count(), 1)}")
    groups = {None: dist.group.WORLD}
    for ax, members in _axis_members(sizes).items():
        for ranks in members:  # every rank creates every group, in one order
            pg = dist.new_group(ranks) if len(ranks) < world else dist.group.WORLD
            if rank in ranks:
                groups[axis_names[ax]] = pg
    return Mesh(axis_names, sizes, rank, groups, dev, dist.get_backend(), None)


def _new_pg(store, prefix: str, rank: int, size: int, backend: str, timeout: float):
    st = dist.PrefixStore(prefix, store)
    td = datetime.timedelta(seconds=timeout)
    if backend == "gloo":
        return dist.ProcessGroupGloo(st, rank, size, td)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = td
        return dist.ProcessGroupNCCL(st, rank, size, opts)
    raise ValueError(f"unknown backend {backend!r}; choose 'gloo' or 'nccl'")


def _rank_mesh(store, sizes, axis_names, rank: int, device, backend: str, timeout: float,
               abort) -> Mesh:
    """Rank `rank`'s mesh of an in-process grid over `store` (its groups
    rendezvous with the other ranks' through the store)."""
    D = sizes[0] * sizes[1]
    groups = {None: _new_pg(store, "world/", rank, D, backend, timeout)}
    for ax, members in _axis_members(sizes).items():
        for gi, ranks in enumerate(members):
            if rank in ranks:
                groups[axis_names[ax]] = _new_pg(store, f"{axis_names[ax]}{gi}/",
                                                 ranks.index(rank), len(ranks), backend,
                                                 timeout)
    return Mesh(axis_names, sizes, rank, groups, device, backend, abort)


def run_ranks(
    fn: Callable[[Mesh], object],
    shape: Tuple[int, int] = (1, 2),
    device="cuda",
    backend: str = "gloo",
    timeout: float = 300.0,
    axis_names: Tuple[str, str] = ("dp", "mp"),
) -> list:
    """Run `fn(mesh)` once per rank of a `shape` mesh, as threads of this
    process; return the ranks' results in rank order.

    `device` is every rank's device, or a sequence with one per rank. The
    groups are gloo over one in-memory store (`backend="nccl"` takes one
    rank per card: NCCL refuses two ranks on one device), each with
    `timeout` seconds. If any rank raises, the others' pending collectives
    stop at once, every rank ends, and the first rank's own exception is
    re-raised here (ranks cut short by it raised `RankAborted`).

    Rank threads share the device's default stream, so their kernels run
    one after another on it; in particular no two K3 launches (whose scan
    CTAs spin on builder CTAs, kernels/gibbs_group.py:folds_per_launch) are
    ever resident at once."""
    sizes = _factor(shape, shape[0] * shape[1])
    D = sizes[0] * sizes[1]
    devs = [_indexed(d) for d in (device if isinstance(device, (list, tuple)) else [device] * D)]
    if len(devs) != D:
        raise ValueError(f"{len(devs)} devices for {D} ranks")
    store = dist.HashStore()
    abort = threading.Event()
    results: list = [None] * D
    errors: list = [None] * D
    meshes: list = [None] * D

    def body(r: int) -> None:
        try:
            if devs[r].type == "cuda":
                torch.cuda.set_device(devs[r])
            meshes[r] = _rank_mesh(store, sizes, axis_names, r, devs[r], backend, timeout, abort)
            results[r] = fn(meshes[r])
            if backend == "nccl":  # release the communicators now, not at exit
                for pg in set(meshes[r].groups.values()):
                    if hasattr(pg, "shutdown"):
                        pg.shutdown()
        except BaseException as err:  # noqa: BLE001 - re-raised below, in the caller
            errors[r] = err
            abort.set()

    threads = [threading.Thread(target=body, args=(r,), name=f"rank{r}", daemon=True)
               for r in range(D)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if any(e is not None for e in errors):
        _ABANDONED.extend(meshes)
        first = next((e for e in errors if e is not None and not isinstance(e, RankAborted)),
                     next(e for e in errors if e is not None))
        raise first
    return results
