"""cv_solve_s: the `<model>_solve` stages of `cv.batched.LAST_TIMER` summed
per call (device work and its read-back), mean over the window's calls."""


def read(ctx):
    if ctx.traffic["route"] != "cv_sweep":
        return None
    per = [sum(v for k, v in s.items() if k.endswith("_solve")) for s in ctx.stages]
    return sum(per) / len(per) if per else None
