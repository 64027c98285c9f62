"""gblup_step_mfu_pct: the whole refit's least time (every stage of
counts/gblup_refit.py at the published peaks) over the window's mean refit
time (window seconds over refits), in percent."""

from counts import gblup_refit


def read(ctx):
    if ctx.traffic["route"] != "gblup_refit":
        return None
    cfg = ctx.config
    least = gblup_refit.refit_least_seconds(cfg["n_entries"], cfg["n_loci"], ctx.traffic["panel"])
    return 100.0 * least * ctx.window["requests"] / ctx.window["seconds"]
