"""device_idle_pct.cv: the share of the traced CV calls' window in which no
operation ran on the device, in percent."""


def read(ctx):
    if ctx.traffic["route"] != "cv_sweep" or not ctx.trace:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
