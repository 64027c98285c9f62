"""Checkpoint/resume for long-running sweeps, copied from
genomicbreedingmodels_tpu/utils/checkpoint.py (stdlib and numpy only).

Two layers:
- `save_state`/`load_state`: atomic npz snapshots of a flat dict of arrays
  (sampler state, accumulated posteriors). The Gibbs chain saves its
  torch.Generator state there as a uint8 array.
- `CVCheckpoint`: job-level resume for cross-validation sweeps — completed CV
  results are appended to a pickle ledger keyed by a stable job signature
  (`job_signature`), so an interrupted cvbulk/cvperpopulation sweep restarts
  where it stopped. Appends take a lock, since the CV executor's worker
  threads record into one ledger.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
import threading
from typing import Dict, Optional

import numpy as np

__all__ = ["save_state", "load_state", "CVCheckpoint", "job_signature"]


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


def job_signature(job: dict) -> str:
    """Stable hash of a CV job's identity (model, trait, index sets, ids)."""
    h = hashlib.sha256()
    model = job["model"]
    h.update(str(getattr(model, "__name__", model)).encode())
    h.update(str(job.get("idx_trait", 0)).encode())
    h.update(np.asarray(job["idx_training"], dtype=np.int64).tobytes())
    h.update(np.asarray(job["idx_validation"], dtype=np.int64).tobytes())
    h.update(str(job.get("replication", "")).encode())
    h.update(str(job.get("fold", "")).encode())
    return h.hexdigest()[:32]


class CVCheckpoint:
    """Pickle ledger of finished CV jobs, appended after each completion.

    The ledger is unpickled on open: open only a ledger this program wrote."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._done: Dict[str, object] = {}
        self._lock = threading.Lock()
        if os.path.exists(path):
            with open(path, "rb") as fh:
                try:
                    while True:
                        sig, cv = pickle.load(fh)
                        self._done[sig] = cv
                except EOFError:
                    pass

    def __contains__(self, sig: str) -> bool:
        return sig in self._done

    def get(self, sig: str):
        return self._done.get(sig)

    def record(self, sig: str, cv) -> None:
        with self._lock:
            self._done[sig] = cv
            d = os.path.dirname(os.path.abspath(self.path)) or "."
            os.makedirs(d, exist_ok=True)
            with open(self.path, "ab") as fh:
                pickle.dump((sig, cv), fh)

    def __len__(self) -> int:
        return len(self._done)
