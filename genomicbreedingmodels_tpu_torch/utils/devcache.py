"""Single-slot device-resident panel cache, copied from
genomicbreedingmodels_tpu/utils/devcache.py.

Call sites that derive device state from the SAME host panel across calls
(repeated chains on one panel: parameter sweeps, model comparisons, warm
benchmarks) cache the derived device tensor keyed on a cheap host
fingerprint, and skip the upload on a hit.

Deliberately ONE slot per cache: the repeat-call pattern is "same panel
again", and a single slot bounds the device memory a cache can pin. The
fingerprint (shape, dtype, byte count, and a strided 4096-element sample
hash) catches rebinding and almost all in-place mutation; pathological
mutations that preserve the sampled stride are the documented trade-off.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np

__all__ = ["host_fingerprint", "SingleSlotCache", "clear_device_caches"]

# Every SingleSlotCache registers itself so one call can release all the
# device memory the reuse slots pin (e.g. before a deliberately huge job).
_REGISTRY: List["SingleSlotCache"] = []


def clear_device_caches() -> int:
    """Empty every device-reuse cache slot; returns how many held a value."""
    n = 0
    for c in _REGISTRY:
        if c._slot is not None:
            n += 1
        c.clear()
    return n


def host_fingerprint(arr) -> Tuple:
    """Cheap content fingerprint of a host array (O(4096) regardless of size)."""
    a = np.asarray(arr)
    flat = a.reshape(-1)
    if flat.size:
        step = max(1, flat.size // 4096)
        sample = np.ascontiguousarray(flat[::step][:4096])
        digest = hash(sample.tobytes())
    else:
        digest = 0
    return (a.shape, a.dtype.str, a.nbytes, digest)


class SingleSlotCache:
    """The slot is one (key, value) tuple, replaced whole: a reader in another
    thread (the CV executor's workers) sees the old pair or the new one,
    never one pair's key with the other's value."""

    def __init__(self) -> None:
        self._slot: Optional[Tuple[Tuple, Any]] = None
        _REGISTRY.append(self)

    def get(self, key: Tuple) -> Any:
        slot = self._slot
        return slot[1] if slot is not None and slot[0] == key else None

    def put(self, key: Tuple, value: Any) -> Any:
        self._slot = (key, value)
        return value

    def clear(self) -> None:
        self._slot = None
