"""k1_roofline: K1's least time (counts/gblup_refit.py: n(n+1)p int8
operations at the int8 peak, or its bytes at the HBM bandwidth, the larger)
over its mean time in the device trace, in percent."""

import harness
from counts import gblup_refit


def read(ctx):
    if ctx.traffic["route"] != "gblup_refit" or ctx.traffic["panel"] != "int8":
        return None
    secs, count = harness.kernel_seconds(ctx.trace, "gram_tri_sm90_kernel", "OpS8")
    if not count:
        return None
    cfg = ctx.config
    return 100.0 * gblup_refit.gram_least_seconds(cfg["n_entries"], cfg["n_loci"], "int8") * count / secs
