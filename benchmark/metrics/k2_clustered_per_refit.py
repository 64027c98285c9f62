"""k2_clustered_per_refit: K2 launches in 2x2 clusters (the program's counter
`gbm.grm.k2.clustered`) over the traced window's refits; 0 where no refit
launched K2 so."""


def read(ctx):
    if ctx.traffic["route"] != "gblup_refit" or ctx.program is None or not ctx.traced_requests:
        return None
    return ctx.program["counters"].get("gbm.grm.k2.clustered", 0) / ctx.traced_requests
