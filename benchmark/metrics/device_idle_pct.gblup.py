"""device_idle_pct.gblup: the share of the traced refits' window in which no
operation ran on the device, in percent."""


def read(ctx):
    if ctx.traffic["route"] != "gblup_refit" or not ctx.trace:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
