"""grm_passes_ms: the Gram stage's memory passes (epilogue, row means,
centering, mirror), a refit's `gbm.grm` device milliseconds less those of
its `gbm.grm.kernel` (the zeroed triangle and K1 or K2), means over the
traced window's refits."""

import harness


def read(ctx):
    grm, kernel = harness.program_span_ms(ctx, "gbm.grm"), harness.program_span_ms(ctx, "gbm.grm.kernel")
    return None if grm is None or kernel is None else grm - kernel
