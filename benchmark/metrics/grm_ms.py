"""grm_ms: the Gram stage of a refit (triangle, epilogue, centering), mean
milliseconds by CUDA events around it in every refit of the window."""


def read(ctx):
    t = ctx.stage_ms.get("grm")
    return sum(t) / len(t) if t else None
