"""cv_eigh_s: the folds' batched eighs of a CV call (ridge's and GBLUP's),
device seconds of the program's `gbm.cv.eigh` spans over the traced
window's calls."""


def read(ctx):
    s = (ctx.program or {}).get("spans", {}).get("gbm.cv.eigh")
    if ctx.traffic["route"] != "cv_sweep" or s is None or s["device_s"] is None or not ctx.traced_requests:
        return None
    return s["device_s"] / ctx.traced_requests
