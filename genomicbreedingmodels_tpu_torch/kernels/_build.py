"""Build the port's CUDA kernels with nvcc and load them with ctypes.

At first use every `csrc/*.cu` is compiled for Hopper (`sm_90a`) into ONE
shared library with a plain C interface, under `build/gbm_torch_kernels/` at
the root of the checkout (git-ignored) when the package runs from a checkout,
and under the process's temporary directory (`tempfile.gettempdir()`, which
honours $TMPDIR) when it is installed. The file name carries a hash of the
sources and flags, so an edited source triggers a rebuild and an unchanged
one reuses the library. A missing nvcc or a failed build raises with nvcc's
own output; nothing falls back to another implementation.

Each C entry point takes raw device pointers, the sizes and the CUDA stream
(all as Python ints), launches on that stream, and returns
`cudaGetLastError()`; `launch` raises when it is not 0.
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

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build", "launch", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_ROOT = Path(__file__).resolve().parents[2]  # the checkout, when the package sits in one
BUILD_DIR = (
    _ROOT / "build" if (_ROOT / "pyproject.toml").is_file() else Path(tempfile.gettempdir())
) / "gbm_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills land in the build log
)
# C entry points: (pointer in, pointer out, n, p, stream) -> cudaError_t.
_ENTRY_POINTS = ("gbm_gram_tri_int8", "gbm_gram_tri_f32", "gbm_gram_tri_bf16")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


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
    """Compile `csrc/*.cu` into the hashed shared library; return its path."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    tag = h.hexdigest()[:16]
    out = BUILD_DIR / f"libgbm_torch_kernels_{tag}.so"
    if out.is_file():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / f"build_{tag}.log").write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {res.returncode}) building {[s.name for s in srcs]}:\n"
            f"{res.stderr}"
        )
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name in _ENTRY_POINTS:
                fn = getattr(lib, name)
                fn.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                ]
                fn.restype = ctypes.c_int
            lib.gbm_cuda_error_string.argtypes = [ctypes.c_int]
            lib.gbm_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(entry: str, src, out, n: int, p: int, stream: int) -> None:
    """Call one C entry point; raise if the launch reports a CUDA error."""
    lib = load()
    rc = getattr(lib, entry)(src, out, n, p, stream)
    if rc != 0:
        msg = lib.gbm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{entry} launch failed: cudaError {rc} ({msg})")
