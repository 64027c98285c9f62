"""Build the port's CUDA kernels with nvcc and load them with ctypes.

At first use every `csrc/*.cu` is compiled for Hopper (`sm_90a`), one nvcc
per source in parallel (headers `csrc/*.cuh` are included, not compiled), and linked into ONE shared library with a plain C interface, under `build/gbm_torch_kernels/` at
the root of the checkout (git-ignored) when the package runs from a checkout,
and under the process's temporary directory (`tempfile.gettempdir()`, which
honours $TMPDIR) when it is installed. The file name carries a hash of the
sources and flags, so an edited source triggers a rebuild and an unchanged
one reuses the library. A missing nvcc or a failed build raises with nvcc's
own output; nothing falls back to another implementation.

Each C entry point takes raw device pointers, the sizes and the CUDA stream
(all as Python ints), launches on that stream, and returns
`cudaGetLastError()`; `launch` raises when it is not 0. `_ENTRY_POINTS`
gives each entry point its own ctypes signature.

`LAUNCHES` counts kernel launches by name, for every wrapper of the port:
a wrapper adds one (`count_launch`) where it launches its kernel and nowhere
else, so a run can show that its main path went through the kernels. The
count is taken under `LAUNCH_LOCK`, so jobs that launch from several host
threads (the CV executor's workers) lose none. Beside the count, a wrapper
may name the operand's (dtype, n, p); `LAUNCH_SHAPES` keeps the set of them
per kernel, so a run can hold a kernel against its plain version at every
shape its path gave it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "LAUNCHES", "LAUNCH_LOCK", "LAUNCH_SHAPES", "NVCC_FLAGS", "build",
           "count_launch", "launch", "load", "reset_launches"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_ROOT = Path(__file__).resolve().parents[2]  # the checkout, when the package sits in one
BUILD_DIR = (
    _ROOT / "build" if (_ROOT / "pyproject.toml").is_file() else Path(tempfile.gettempdir())
) / "gbm_torch_kernels"
NVCC_FLAGS = (  # per source, with -c; the objects are linked with -shared
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills land in the build log
)
_PTR, _SIZE = ctypes.c_void_p, ctypes.c_longlong
# C entry points -> argument types; each returns a cudaError_t as int.
_GRAM = (_PTR, _PTR, _SIZE, _SIZE, _PTR)  # (pointer in, pointer out, n, p, stream)
_ENTRY_POINTS = {
    "gbm_gram_tri_int8": _GRAM,
    "gbm_gram_tri_f32": _GRAM,
    "gbm_gram_tri_bf16": _GRAM,
    "gbm_gram_tri_bf16_schedule": (_PTR, _PTR, _SIZE, _SIZE, ctypes.c_int, _PTR),  # + quad (0 or 1)
    # (Cb, u, b, s2, val, eta, gum, sig_e2, pi, delta, b_new, incl, bs, K,
    #  tables, flags, epoch, slice_floats, staged_quads, folds,
    #  the six fold strides, stream)
    "gbm_gibbs_group": (_PTR,) * 12 + (_SIZE, _SIZE, _PTR, _PTR) + (_SIZE,) * 10 + (_PTR,),
}

# Kernel launches by the wrappers (CUDA tensors only; plain versions never count).
LAUNCHES = {"gram_tri_int8": 0, "gram_tri_float": 0, "gibbs_group": 0}
# The shapes each kernel was launched at: (dtype, n, p) operands of K1/K2,
# (folds, bs, K) of K3.
LAUNCH_SHAPES: dict[str, set] = {k: set() for k in LAUNCHES}
# Guards LAUNCHES, and K3's per-stream workspaces with their epochs
# (kernels/gibbs_group.py), which must change together with the count.
# Re-entrant: K3's wrapper counts inside its workspace section.
LAUNCH_LOCK = threading.RLock()

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def count_launch(name: str, shape: tuple | None = None) -> None:
    """One more launch of kernel `name` (a read-modify-write, hence the
    lock), at `shape` where the wrapper gives it (see LAUNCH_SHAPES)."""
    with LAUNCH_LOCK:
        LAUNCHES[name] += 1
        if shape is not None:
            LAUNCH_SHAPES[name].add(shape)


def reset_launches() -> None:
    with LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
            LAUNCH_SHAPES[k].clear()


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and /usr/local/cuda/bin): "
        "the port's CUDA kernels are built from source at first use"
    )


def build() -> Path:
    """Compile `csrc/*.cu` into the hashed shared library; return its path.

    One nvcc per source, all started together, then one link: the build
    takes as long as the slowest source, not the sum."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sorted(srcs + list(CSRC.glob("*.cuh"))):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    tag = h.hexdigest()[:16]
    out = BUILD_DIR / f"libgbm_torch_kernels_{tag}.so"
    if out.is_file():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    objs = [BUILD_DIR / f"{s.stem}_{tag}.{pid}.o" for s in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]  # waits for every compile
    results = [(c, p.returncode, o, e) for c, p, (o, e) in zip(cmds, procs, outs)]
    tmp = out.with_name(f"{out.name}.{pid}.tmp")
    failed = [r for r in results if r[1] != 0]
    if not failed:
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        results.append((link, res.returncode, res.stdout, res.stderr))
        failed = [r for r in results if r[1] != 0]
    (BUILD_DIR / f"build_{tag}.log").write_text(
        "".join(" ".join(c) + "\n" + o + e for c, _, o, e in results))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{' '.join(c)} (exit {rc}):\n{e}" for c, rc, _, e in failed))
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.gbm_cuda_error_string.argtypes = [ctypes.c_int]
            lib.gbm_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(entry: str, *args) -> None:
    """Call one C entry point with its arguments (pointers, sizes and the
    stream, as ints); raise if the launch reports a CUDA error."""
    lib = load()
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        msg = lib.gbm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{entry} launch failed: cudaError {rc} ({msg})")
