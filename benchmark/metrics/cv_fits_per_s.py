"""cv_fits_per_s: the fits of every CV call of the window (replications ×
folds × models), over the window (first call's start to the last's end)."""


def read(ctx):
    if ctx.traffic["route"] != "cv_sweep":
        return None
    return ctx.window["work"] / ctx.window["seconds"]
