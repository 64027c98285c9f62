"""gblup_fit_p95_ms.int8: the int8 refit's tail, as gblup_fit_p95_ms defines
it; a per-layer metric of the cell whose rate decides."""

import harness


def read(ctx):
    if ctx.traffic["route"] != "gblup_refit" or ctx.traffic["panel"] != "int8":
        return None
    return harness.percentile(ctx.window["latencies_s"], 95) * 1e3
