"""solve_ms: `gblup_solve_lower` of a refit, mean device milliseconds of the
program's `gbm.solve` span over the traced window's refits."""

import harness


def read(ctx):
    return harness.program_span_ms(ctx, "gbm.solve")
