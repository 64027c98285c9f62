"""cv_lasso_idle_pct: the share of the traced CV calls' window in which the
device idled while the host was inside the lasso's solve (`gbm.cv.lasso_solve`
or a `gbm.cv.lasso.` span), idle cut where spans open and close, in percent."""

import harness


def read(ctx):
    if ctx.traffic["route"] != "cv_sweep" or "lasso" not in ctx.config["models"]:
        return None
    idle = harness.idle_under(ctx, "gbm.cv.lasso_solve", "gbm.cv.lasso.")
    return None if idle is None else 100.0 * idle / ctx.trace["window_s"]
