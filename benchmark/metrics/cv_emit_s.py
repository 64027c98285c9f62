"""cv_emit_s: the `<model>_emit` and `lasso_grid` stages of
`cv.batched.LAST_TIMER` summed per call (host assembly of the Fit and CV
records), mean over the window's calls."""


def read(ctx):
    if ctx.traffic["route"] != "cv_sweep":
        return None
    per = [sum(v for k, v in s.items() if k.endswith("_emit") or k == "lasso_grid") for s in ctx.stages]
    return sum(per) / len(per) if per else None
