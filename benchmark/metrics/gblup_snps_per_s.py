"""gblup_snps_per_s: n·p per refit times the refits of the window, over the
window (first refit's start to the last one's GEBVs on the host)."""


def read(ctx):
    if ctx.traffic["route"] != "gblup_refit":
        return None
    return ctx.window["work"] / ctx.window["seconds"]
