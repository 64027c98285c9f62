"""Checkpoint/resume for long-running sweeps, copied from
genomicbreedingmodels_tpu/utils/checkpoint.py (`save_state`/`load_state`).

`save_state`/`load_state` write and read atomic npz snapshots of a flat dict
of arrays (sampler state, accumulated posteriors). The Gibbs chain saves its
torch.Generator state there as a uint8 array. `CVCheckpoint` and
`job_signature` arrive with the CV harness (ROADMAP queue A, step 4).
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional

import numpy as np

__all__ = ["save_state", "load_state"]


def save_state(path: str, state: Dict[str, np.ndarray]) -> None:
    """Atomic write: tmp file + rename."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **{k: np.asarray(v) for k, v in state.items()})
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_state(path: str) -> Optional[Dict[str, np.ndarray]]:
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
