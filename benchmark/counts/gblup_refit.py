"""The least work of one GBLUP refit, stage by stage, and the card's peaks.

Frozen copy of the counts in `bench_torch.py:headline_split` (int8 route)
and of its bf16 twin: each stage's operations, the peak they run at and the
bytes it has to move, reading each input once and writing each output once.
A stage's least time is the larger of operations over that peak and bytes
over the memory bandwidth.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W).
"""

from __future__ import annotations

PEAKS = {  # operations per second
    "int8": 1979e12,
    "bf16": 989e12,
    "f32": 67e12,
}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, peak: str, nbytes: float) -> float:
    return max(ops / PEAKS[peak], nbytes / HBM_BYTES_PER_S)


def stages(n: int, p: int, panel: str) -> list[tuple[str, float, str, float]]:
    """(stage, operations, peak, bytes) of one refit of an (n, p) panel.

    int8: K1's lower triangle (int32), the int32 -> f32 epilogue, the
    centering, the mirror and diagonal add, potrf, potrs and the GEBVs.
    bf16: K2's lower triangle (f32), the mirror, the centering, the mirror
    and diagonal add of the solve, potrf, potrs and the GEBVs.
    """
    n2 = float(n) * n
    if panel == "int8":
        gram = ("K1 (gram_tri_int8)", n * (n + 1.0) * p, "int8", n * float(p) + 2.0 * n * (n + 1))
        pre = [("epilogue (int32 -> f32)", n2, "f32", 8 * n2),
               ("centering", 6 * n2, "f32", 8 * n2)]
    elif panel == "bf16":
        gram = ("K2 (gram_tri_float, bf16)", n * (n + 1.0) * p, "bf16", 2.0 * n * p + 2.0 * n * (n + 1))
        pre = [("mirror", n2, "f32", 8 * n2),
               ("centering", 6 * n2, "f32", 8 * n2)]
    else:
        raise ValueError(f"unknown panel {panel!r}")
    return [gram, *pre,
            ("mirror + diagonal add", n2, "f32", 8 * n2),
            ("potrf", n * n2 / 3, "f32", 8 * n2),
            ("potrs + GEBV", 2 * n2, "f32", 4 * n2 + 12.0 * n)]


def gram_least_seconds(n: int, p: int, panel: str) -> float:
    _, ops, peak, nbytes = stages(n, p, panel)[0]
    return least_seconds(ops, peak, nbytes)


def refit_least_seconds(n: int, p: int, panel: str) -> float:
    return sum(least_seconds(o, k, b) for _, o, k, b in stages(n, p, panel))
