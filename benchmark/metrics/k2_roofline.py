"""k2_roofline: K2's least time on a bf16 panel (counts/gblup_refit.py:
n(n+1)p bf16 operations at the bf16 peak, or its bytes, the larger) over its
mean time in the device trace, in percent."""

import harness
from counts import gblup_refit


def read(ctx):
    if ctx.traffic["route"] != "gblup_refit" or ctx.traffic["panel"] != "bf16":
        return None
    secs, count = harness.kernel_seconds(ctx.trace, "gram_tri_sm90_kernel", "OpBF16")
    if not count:
        return None
    cfg = ctx.config
    return 100.0 * gblup_refit.gram_least_seconds(cfg["n_entries"], cfg["n_loci"], "bf16") * count / secs
