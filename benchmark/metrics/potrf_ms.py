"""potrf_ms: the factor of K + λI (`cholesky_ex`, with the copies it runs
around cuSOLVER's), mean device milliseconds of the program's
`gbm.solve.potrf` span over the traced window's refits."""

import harness


def read(ctx):
    return harness.program_span_ms(ctx, "gbm.solve.potrf")
