"""step_mfu: the traced keyframe cycle's whole compositing work (per
kernel and phase, the sampled launches' mean float32 operations times the
cycle's launch count) over the cycle's time at the H100's published
float32 peak, in %.
Only the slab kernels' work is counted, so it is a floor of the whole
step's share."""

from slambench import roofline


def read(ctx):
    ops = 0.0
    for k in ctx["kernels"].values():
        for ph in k["phases"].values():
            if ph["n"] and ph.get("launches"):
                ops += ph["ops"] / ph["n"] * ph["launches"]
    cyc = ctx["traces"].get("cycle")
    sec = cyc["window_s"] if cyc else 0.0
    return 100.0 * ops / (sec * roofline.PEAK_FP32_FLOPS) if ops and sec > 0 else None
