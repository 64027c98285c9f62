"""gblup_program_idle_ms: the device's idle milliseconds a refit while the
host was inside one of the program's `gbm.` spans, the traced window's idle
cut where spans open and close (`harness.split_gaps`), over its refits."""

import harness


def read(ctx):
    idle = harness.idle_under(ctx, harness.PROGRAM_SPAN)
    if ctx.traffic["route"] != "gblup_refit" or idle is None or not ctx.traced_requests:
        return None
    return 1e3 * idle / ctx.traced_requests
