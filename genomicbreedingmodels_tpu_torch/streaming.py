"""Out-of-core streaming: disk → host → device pipelines for panels bigger
than the card (or bigger than host RAM).

Port of genomicbreedingmodels_tpu/streaming.py. A background thread decodes
the next PLINK .bed marker shard while the device computes on the current
one, and the raw-Gram-is-additive identity K = P (Σ_k X_k X_kᵀ) P
(ops/grm.py:center_gram) lets the GRM accumulate shard by shard with the
centering applied exactly once at the end: the full panel never exists
anywhere.

The host→device stage (`_iter_device_ahead`) is a side CUDA stream over a
ring of two page-locked (pinned) host buffers (`_PinnedRing`): the decoder
writes each shard straight into a ring buffer, the copy runs asynchronously
on the side stream, and the consumer's stream waits on the copy's event, so
decode, transfer and the Gram kernels overlap. A buffer is refilled only
after its copy's event has completed; no shard is pinned anew.

Every entry point takes `device=` (default "cuda"); `device="cpu"` runs the
same pipeline with the kernels' plain versions and no pinned memory.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from .device import resolve_device
from .utils.logging import StageTimer

__all__ = [
    "BedShardStreamer",
    "grm_from_bed",
    "gblup_from_bed",
    "gblup_from_bed_pieces",
]

_BED_MAGIC = b"\x6c\x1b\x01"

Alloc = Callable[[tuple, np.dtype], np.ndarray]


def _alloc_numpy(shape, dtype) -> np.ndarray:
    return np.empty(shape, dtype=dtype)


class _PinnedRing:
    """A ring of SLOTS page-locked host buffers that shards are decoded into
    and uploaded from, with the side stream the uploads run on.

    Slot k of the ring serves shards k, k + SLOTS, ...: `take` hands a slot
    to the decoder only after the previous shard in it was handed to `upload`
    (a condition variable) AND that upload's copy has completed (its CUDA
    event), so a buffer is never overwritten while a copy reads it. A buffer
    grows when a larger shard comes and is kept otherwise. `close` wakes and
    fails a decoder blocked in `take`, so a consumer that stops early (an
    exception, a rejected panel) never leaves the decode thread hanging.
    """

    SLOTS = 2  # double buffering: one shard decodes while the other is copied

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._bufs: list = [None] * self.SLOTS
        self._events: list = [None] * self.SLOTS
        self._issued = [True] * self.SLOTS
        self._next = 0
        self._closed = False
        self._cv = threading.Condition()

    def take(self) -> int:
        with self._cv:
            i = self._next
            self._next = (i + 1) % len(self._bufs)
            self._cv.wait_for(lambda: self._issued[i] or self._closed)
            if self._closed:
                raise RuntimeError("the pinned ring was closed")
            self._issued[i] = False
            ev = self._events[i]
        if ev is not None:
            ev.synchronize()
        return i

    def view(self, i: int, shape, dtype) -> np.ndarray:
        """Slot i's buffer as a numpy array of `shape` and `dtype` (grown as needed)."""
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        if self._bufs[i] is None or self._bufs[i].numel() < nbytes:
            self._bufs[i] = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
        return self._bufs[i][:nbytes].numpy().view(dtype).reshape(shape)

    def _slot_of(self, host: np.ndarray) -> Optional[int]:
        ptr = host.__array_interface__["data"][0]
        for i, buf in enumerate(self._bufs):
            if buf is not None and buf.data_ptr() <= ptr < buf.data_ptr() + buf.numel():
                return i
        return None

    def upload(self, host: np.ndarray):
        """Start the copy of `host` to the device on the side stream; returns
        (device tensor, the copy's event). A `host` outside the ring (a plain
        numpy shard) is first copied into the next slot: either every shard
        of a stream comes from the ring, or none does."""
        i = self._slot_of(host)
        if i is None:
            i = self.take()
            staged = self.view(i, host.shape, host.dtype)
            np.copyto(staged, host)
            host = staged
        dtype = torch.from_numpy(host[:0]).dtype
        src = self._bufs[i][: host.nbytes].view(dtype).view(host.shape)
        with torch.cuda.stream(self.stream):
            dev = torch.empty(host.shape, dtype=src.dtype, device=self.device)
            dev.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        with self._cv:
            self._events[i] = ev
            self._issued[i] = True
            self._cv.notify_all()
        return dev, ev

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()


def _iter_device_ahead(shards, depth: int = 1, device="cuda", ring: Optional[_PinnedRing] = None):
    """Double-buffered host→device stage: yield `(start, stop, tensor)` on
    `device`, with the NEXT shards' copies already running on a side stream
    while the caller computes on the current one (`depth + 1` shards in
    flight, so the device holds one extra shard).

    On the card the copies go from the pinned ring (`ring`, or a new ring of
    two buffers) on the ring's side stream; before a shard is yielded the
    caller's current stream waits on its copy's event, and the tensor is
    recorded on that stream so the caching allocator does not hand its
    memory out again while the caller's kernels still read it. On the CPU
    the shards are wrapped as they are.

    GBM_STREAM_H2D_AHEAD=0 keeps the JAX package's escape hatch: inline
    (synchronous) uploads, one shard at a time.
    """
    dev = resolve_device(device)
    it = iter(shards)
    if dev.type == "cuda":
        ring = ring if ring is not None else _PinnedRing(dev)
    inline = os.environ.get("GBM_STREAM_H2D_AHEAD", "1") == "0"
    pending = collections.deque()

    def _pull() -> bool:
        try:
            a, b, host = next(it)
        except StopIteration:
            return False
        pending.append((a, b, *ring.upload(host)))
        return True

    try:
        if dev.type != "cuda":
            for a, b, host in it:
                yield a, b, torch.from_numpy(np.asarray(host))
            return
        for _ in range(1 if inline else depth + 1):
            if not _pull():
                break
        while pending:
            a, b, t, ev = pending.popleft()
            if inline:
                ev.synchronize()
            else:
                _pull()  # start the next upload BEFORE handing over this shard
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(ev)
            t.record_stream(stream)
            yield a, b, t
            if inline:
                _pull()
    finally:
        if ring is not None:
            ring.close()  # first: a decoder blocked on a slot must not hold up the close below
        close = getattr(it, "close", None)
        if close is not None:
            close()


class BedShardStreamer:
    """Iterate `(start, stop, F)` marker shards of a PLINK .bed trio with
    background prefetch.

    F is float32 (n × shard_cols) allele frequencies; missing genotypes are
    imputed to the column mean (the standard VanRaden convention — an imputed
    cell contributes exactly zero after centering). `prefetch` shards are
    decoded ahead on a worker thread. The same shards, byte for byte, as the
    JAX package's streamer.
    """

    def __init__(
        self,
        prefix: Union[str, os.PathLike],
        block_cols: int = 32_768,
        prefetch: int = 2,
        impute_missing: bool = True,
    ):
        self.prefix = Path(prefix)
        self.block_cols = int(block_cols)
        if self.block_cols < 1:
            raise ValueError(f"block_cols must be >= 1, got {block_cols}")
        self.prefetch = max(1, int(prefetch))
        self.impute_missing = bool(impute_missing)
        fam = np.loadtxt(self.prefix.with_suffix(".fam"), dtype=str, delimiter="\t", ndmin=2)
        self.entries = fam[:, 1].astype(object)
        self.populations = fam[:, 0].astype(object)
        self.n = len(self.entries)
        self._bytes_per_snp = (self.n + 3) // 4
        bed = self.prefix.with_suffix(".bed")
        size = bed.stat().st_size
        with open(bed, "rb") as fh:
            if fh.read(3) != _BED_MAGIC:
                raise ValueError(f"{bed}: bad PLINK magic (or sample-major, unsupported)")
        self.p = (size - 3) // self._bytes_per_snp

    def _read_payload(self, start: int, stop: int, alloc: Alloc = _alloc_numpy) -> np.ndarray:
        """The packed bytes of markers [start, stop) as (stop - start, ceil(n/4)) uint8,
        read straight into the array `alloc` gives."""
        cols = stop - start
        out = alloc((cols, self._bytes_per_snp), np.uint8)
        with open(self.prefix.with_suffix(".bed"), "rb") as fh:
            fh.seek(3 + start * self._bytes_per_snp)
            got = fh.readinto(memoryview(out).cast("B"))
        if got != out.nbytes:
            raise ValueError(f"{self.prefix.with_suffix('.bed')}: truncated payload")
        return out

    def _decode_shard(self, start: int, stop: int, alloc: Alloc = _alloc_numpy) -> np.ndarray:
        payload = self._read_payload(start, stop)
        cols = stop - start
        F = np.empty((self.n, cols), dtype=np.float64)
        from .native.lib import load_native

        lib = load_native()
        if lib is not None:
            import ctypes

            lib.gbmio_bed_decode(
                payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self.n, cols,
                F.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), 0,
            )
        else:
            lut = np.array([0.0, np.nan, 0.5, 1.0])
            codes = np.stack(
                [(payload >> shift) & 0x3 for shift in (0, 2, 4, 6)], axis=-1
            ).reshape(cols, -1)[:, : self.n]
            F[:] = lut[codes].T
        F32 = alloc(F.shape, np.float32)
        F32[:] = F
        if self.impute_missing and np.isnan(F32).any():
            mu = np.nanmean(F32, axis=0)
            mu = np.where(np.isfinite(mu), mu, 0.0).astype(np.float32)
            ij = np.where(np.isnan(F32))
            F32[ij] = mu[ij[1]]
        return F32

    def _decode_shard_dosage(self, start: int, stop: int, snp_major: bool = False,
                             alloc: Alloc = _alloc_numpy):
        """Decode a shard straight to int8 dosages {0, 1, 2} (-1 = missing).

        With `snp_major` the shard comes back (cols, n) in the .bed's native
        order, with no host transpose (the device transposes it, into the
        buffer K1 reads: ops/grm.py:entry_major). Returns None when the shard
        contains missing calls: the caller then takes the imputed float path
        for that shard.
        """
        payload = self._read_payload(start, stop)
        cols = stop - start
        from .native.lib import load_native

        lib = load_native()
        if lib is not None:
            import ctypes

            D = alloc((cols, self.n) if snp_major else (self.n, cols), np.int8)
            n_missing = ctypes.c_long(0)
            lib.gbmio_bed_decode_i8(
                payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self.n, cols,
                D.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), 0,
                ctypes.byref(n_missing), 1 if snp_major else 0,
            )
            return None if n_missing.value > 0 else D
        # The float LUT [0.0, nan, 0.5, 1.0] of _decode_shard times ploidy 2:
        # code0→0, code2→1, code3→2, code1 (missing)→-1.
        lut = np.array([0, -1, 1, 2], dtype=np.int8)
        codes = np.stack(
            [(payload >> shift) & 0x3 for shift in (0, 2, 4, 6)], axis=-1
        ).reshape(cols, -1)[:, : self.n]
        D = lut[codes]  # (cols, n) int8, .bed native order
        if (D < 0).any():
            return None
        out = alloc(D.shape if snp_major else D.T.shape, np.int8)
        out[:] = D if snp_major else D.T
        return out

    def __len__(self) -> int:
        return -(-self.p // self.block_cols)

    def _decode_auto(self, start: int, stop: int, snp_major: bool = False,
                     alloc: Alloc = _alloc_numpy):
        """int8 dosage shard when complete, imputed float32 shard otherwise."""
        D = self._decode_shard_dosage(start, stop, snp_major=snp_major, alloc=alloc)
        return D if D is not None else self._decode_shard(start, stop, alloc=alloc)

    def _iter_with(self, decode, ring: Optional[_PinnedRing] = None
                   ) -> Iterator[Tuple[int, int, np.ndarray]]:
        """Yield `decode(start, stop, alloc)` per shard, `prefetch` shards
        decoded ahead on a worker thread. With a `ring`, each shard is decoded
        into a ring slot the worker takes first (blocking until the slot is
        free); without one, into fresh numpy arrays."""
        bounds = [
            (s, min(s + self.block_cols, self.p))
            for s in range(0, self.p, self.block_cols)
        ]

        def job(a: int, b: int):
            if ring is None:
                return decode(a, b, _alloc_numpy)
            i = ring.take()
            return decode(a, b, lambda shape, dtype: ring.view(i, shape, dtype))

        pool = ThreadPoolExecutor(max_workers=1)
        try:
            futures = [pool.submit(job, a, b) for a, b in bounds[: self.prefetch]]
            for k, (a, b) in enumerate(bounds):
                nxt = k + self.prefetch
                if nxt < len(bounds):
                    futures.append(pool.submit(job, *bounds[nxt]))
                yield a, b, futures[k].result()
                futures[k] = None  # release the decoded shard
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def __iter__(self) -> Iterator[Tuple[int, int, np.ndarray]]:
        return self._iter_with(self._decode_shard)

    def iter_dosage(self, snp_major: bool = False) -> Iterator[Tuple[int, int, np.ndarray]]:
        """Like iter(), but shards without missing calls come back as int8
        dosages (the exact K1 path); shards with missing fall back to imputed
        float32 (always sample-major). `snp_major` keeps the int8 shards in
        the .bed's native (cols, n) order: no host transpose; pair with
        `ops.grm.gram_dosage_snp_major` (layout distinguishable by dtype:
        int8 ⇒ snp-major, float32 ⇒ sample-major)."""
        return self._iter_with(self._dosage_decoder(snp_major))

    def _dosage_decoder(self, snp_major: bool):
        return lambda a, b, alloc: self._decode_auto(a, b, snp_major=snp_major, alloc=alloc)

    def iter_payload(self) -> Iterator[Tuple[int, int, np.ndarray]]:
        """Yield RAW packed shards `(start, stop, (cols, ceil(n/4)) uint8)`.

        No host decode at all: the 2-bit payload ships to the device as it is
        (4 genotypes a byte, a quarter of the bytes of int8 dosages) and
        `ops.pieces.unpack_bed_payload` expands it on the device.
        """
        return self._iter_with(self._read_payload)


@contextlib.contextmanager
def _stage(timer: Optional[StageTimer], name: str, dev: torch.device):
    """`timer.stage(name)` ending in a device synchronise, so that the stage
    counts the device work it enqueued; nothing without a timer."""
    if timer is None:
        yield
        return
    with timer.stage(name):
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _device_shards(streamer: BedShardStreamer, decode, dev: torch.device):
    """`(start, stop, tensor)` on `dev`: decoded into the pinned ring and
    uploaded ahead on the card, decoded into numpy and wrapped on the CPU."""
    ring = _PinnedRing(dev) if dev.type == "cuda" else None
    return _iter_device_ahead(streamer._iter_with(decode, ring), device=dev, ring=ring)


def grm_from_bed(
    prefix: Union[str, os.PathLike],
    block_cols: int = 32_768,
    prefetch: int = 2,
    dtype: Optional[str] = None,
    center: bool = True,
    device="cuda",
    timer: Optional[StageTimer] = None,
) -> torch.Tensor:
    """Out-of-core centered Gram matrix straight from a PLINK .bed file, as an
    (n, n) f32 tensor on `device`.

    Shards with complete calls ride the exact int8 dosage path: each goes
    SNP-major to the device, is transposed there into K1's operand
    (ops/grm.py:gram_tri_snp_major) and K1's raw int32 lower triangle is
    added to a running int32 triangle, exactly. Shards containing missing
    calls are mean-imputed on the host and take K2 at `dtype` (float32 unless
    "bfloat16" is asked for: the JAX package's bf16 default is the TPU's),
    whose raw f32 lower triangles add up beside it. The triangles are scaled
    (1/ploidy², ploidy 2), mirrored and double-centered ONCE at the end, so
    no per-shard n×n matrix is ever mirrored or added in f32. Pass
    dtype="float32"/"bfloat16" to force the float path for every shard.
    Peak device memory: the two running triangles, one shard's K1 or K2
    output and `depth + 2` shards. A `timer` gets the stages "stream" (disk,
    decode, upload and the Gram kernels, overlapped) and "center".
    """
    from .kernels.gram_tri import gram_tri_float
    from .ops.grm import _mirror, center_gram, gram_tri_snp_major

    dev = resolve_device(device)
    force_float = dtype is not None
    if dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"dtype must be None, 'float32' or 'bfloat16', got {dtype!r}")
    fdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    streamer = BedShardStreamer(prefix, block_cols=block_cols, prefetch=prefetch)
    decode = streamer._decode_shard if force_float else streamer._dosage_decoder(snp_major=True)
    acc_int = acc_float = None
    with _stage(timer, "stream", dev), \
            contextlib.closing(_device_shards(streamer, decode, dev)) as shards:
        for _, _, F in shards:
            if F.dtype == torch.int8:
                L = gram_tri_snp_major(F, ploidy=2, device=dev)
                acc_int = L if acc_int is None else acc_int.add_(L)
            else:
                L = gram_tri_float(F.to(fdt).contiguous())
                acc_float = L if acc_float is None else acc_float.add_(L)
            del F, L
    if acc_int is None and acc_float is None:
        raise ValueError(f"{prefix}: no markers")
    with _stage(timer, "center", dev):
        K = acc_int.to(torch.float32).div_(4.0) if acc_int is not None else None
        del acc_int
        if acc_float is not None:
            K = acc_float if K is None else K.add_(acc_float)
        K = _mirror(K)
        if center:
            K = center_gram(K)
    return K


def gblup_from_bed(
    prefix: Union[str, os.PathLike],
    y: np.ndarray,
    lam: float = 0.1,
    block_cols: int = 32_768,
    prefetch: int = 2,
    dtype: Optional[str] = None,
    device="cuda",
    timer: Optional[StageTimer] = None,
):
    """Out-of-core GBLUP: stream the panel once for the GRM, then one
    Cholesky mixed-model solve (cuSOLVER on the card). Returns (gebv, K) as
    tensors on `device`; K is kinship-scaled (mean diagonal 1) and `lam`
    is on that scale. A `timer` gets grm_from_bed's stages and "solve"."""
    K = grm_from_bed(prefix, block_cols=block_cols, prefetch=prefetch, dtype=dtype,
                     device=device, timer=timer)
    with _stage(timer, "solve", K.device):
        K = K / K.diagonal().mean().clamp_min(1e-12)  # kinship-scale
        y = torch.as_tensor(np.asarray(y, dtype=np.float32)).to(K.device)
        mu = y.mean()
        yc = y - mu
        A = K.clone()
        A.diagonal().add_(float(lam))
        L, _ = torch.linalg.cholesky_ex(A)  # not positive definite: NaN GEBVs, as the JAX solve
        del A
        alpha = torch.cholesky_solve(yc[:, None], L)[:, 0]
        gebv = yc - float(lam) * alpha + mu
    return gebv, K


def gblup_from_bed_pieces(
    prefix: Union[str, os.PathLike],
    y: np.ndarray,
    lam: float = 0.1,
    block_cols: int = 32_768,
    block_rows: int = 4_096,
    prefetch: int = 2,
    cg_iters: int = 30,
    device="cuda",
    timer: Optional[StageTimer] = None,
) -> Tuple[np.ndarray, float]:
    """Out-of-core GBLUP where the square Gram need not exist: the Gram only
    ever exists as lower-trapezoid int32 pieces (ops/pieces.py) and the
    mixed-model solve is matrix-free CG.

    Disk .bed → PACKED 2-bit shards straight to the device (4 genotypes a
    byte; the host never decodes) → on-device unpack + exact int32 piece
    products added in place → piecewise double-centering → CG. `lam` is on
    the kinship scale (as `gblup_from_bed`: λ multiplies mean(diag K)).
    Requires complete calls: missing calls are COUNTED on the device and the
    stream FAILS FAST: the counter is read back after the first shard and
    every 8th shard after it (one scalar readback each), so a dirty panel is
    rejected within ~8 shards instead of after the whole stream. Impute
    upstream or use the dense `gblup_from_bed`. A `timer` gets the stages
    "stream" (disk, upload, unpack and piece products, overlapped) and
    "solve" (centering and CG).
    Returns (gebv as float64 numpy, cg_residual_norm).
    """
    from .ops.pieces import accumulate_bed_payload, gblup_from_pieces, make_bounds, zero_pieces

    dev = resolve_device(device)
    streamer = BedShardStreamer(prefix, block_cols=block_cols, prefetch=prefetch)
    n = streamer.n
    bounds = make_bounds(n, block_rows)
    pieces = zero_pieces(n, bounds, device=dev)
    miss = torch.zeros((), dtype=torch.int64, device=dev)

    def _reject(miss_count: int) -> None:
        raise ValueError(
            f"{prefix}: {miss_count} missing calls — the exact pieces path "
            "needs complete dosages; impute upstream or use gblup_from_bed"
        )

    with _stage(timer, "stream", dev), \
            contextlib.closing(_device_shards(streamer, streamer._read_payload, dev)) as shards:
        for k, (_, _, payload) in enumerate(shards):
            pieces, miss = accumulate_bed_payload(pieces, payload, miss, bounds=bounds, n=n)
            del payload
            # Fail fast on a dirty panel: the first shard catches systematic
            # missingness at once; every 8th after it bounds the wasted stream.
            if (k == 0 or k % 8 == 7) and int(miss) > 0:
                _reject(int(miss))
        if int(miss) > 0:
            _reject(int(miss))
    with _stage(timer, "solve", dev):
        gebv, resid = gblup_from_pieces(pieces, np.asarray(y, dtype=np.float32), bounds,
                                        ploidy=2, lam_rel=float(lam), iters=int(cg_iters))
    return gebv.cpu().numpy().astype(np.float64), float(resid)
