"""Build and load the port's native gbmio library (ctypes).

Port of genomicbreedingmodels_tpu/native/lib.py. The port keeps its own copy
of the C++ source, `native/src/gbmio.cpp`, and builds it at first use with
the system g++ (C++17, -O3, -pthread, the reference's flags) into a file
whose name carries a hash of the source and flags: under
`build/gbm_torch_native/` at the root of the checkout (git-ignored) when the
package runs from one, else under the process's temporary directory. It never
reads or writes the JAX package's directory. Any failure (no g++, a failed
compile, a library that does not load) makes `load_native()` return None, and
io.py then takes its numpy decoders, as the reference does. No pybind11: the
ABI is plain C, bound with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

__all__ = ["BUILD_DIR", "CXX_FLAGS", "SRC", "library_path", "load_native", "native_available"]

SRC = Path(__file__).resolve().parent / "src" / "gbmio.cpp"
_ROOT = Path(__file__).resolve().parents[2]  # the checkout, when the package sits in one
BUILD_DIR = (
    _ROOT / "build" if (_ROOT / "pyproject.toml").is_file() else Path(tempfile.gettempdir())
) / "gbm_torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library for this source and these flags is (or will be) built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libgbmio_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0 or not tmp.is_file():
            return False
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def load_native() -> Optional[ctypes.CDLL]:
    """Return the loaded library, building it if necessary; None on failure."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            out = library_path()
        except OSError:
            return None
        if not out.is_file() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        c_long, c_int, c_char_p = ctypes.c_long, ctypes.c_int, ctypes.c_char_p
        dp = ctypes.POINTER(ctypes.c_double)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i8p = ctypes.POINTER(ctypes.c_int8)
        lp = ctypes.POINTER(c_long)
        signatures = {
            "gbmio_tsv_dims": [c_char_p, lp, lp],
            "gbmio_tsv_parse": [c_char_p, c_long, c_long, dp, c_long, c_long, c_int, lp],
            "gbmio_bed_decode": [u8p, c_long, c_long, dp, c_int],
            "gbmio_bed_decode_i8": [u8p, c_long, c_long, i8p, c_int, lp, c_int],
            "gbmio_bed_encode": [dp, c_long, c_long, u8p, c_int],
            "gbmio_col_means": [dp, c_long, c_long, dp, c_int],
            "gbmio_quantize_grid": [dp, c_long, ctypes.c_double, ctypes.c_double, u8p, c_int],
            "gbmio_vcf_dims": [c_char_p, lp, lp, lp],
            "gbmio_vcf_parse": [c_char_p, dp, c_long, c_long, c_int, lp],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_native() is not None
