"""solve_ms: `gblup_solve_lower` of a refit, mean milliseconds by CUDA events
around it in every refit of the window."""


def read(ctx):
    t = ctx.stage_ms.get("solve")
    return sum(t) / len(t) if t else None
