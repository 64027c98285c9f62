"""grm_ms: the Gram stage of a refit (triangle, epilogue, centering), mean
device milliseconds of the program's `gbm.grm` span over the traced
window's refits (its two CUDA events on the stream)."""

import harness


def read(ctx):
    return harness.program_span_ms(ctx, "gbm.grm")
