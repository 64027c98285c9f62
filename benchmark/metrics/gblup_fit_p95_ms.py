"""gblup_fit_p95_ms: the 95th percentile over every refit of the window,
issue to GEBVs on the host, host clock."""

import harness


def read(ctx):
    if ctx.traffic["route"] != "gblup_refit":
        return None
    return harness.percentile(ctx.window["latencies_s"], 95) * 1e3
