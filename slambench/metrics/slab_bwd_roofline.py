"""slab_bwd_roofline: the sampled slab_bwd launches' least time on the
H100 (roofline.py: the reference's work over the published float32 and
HBM peaks) over their time by CUDA events, in %."""


def read(ctx):
    k = ctx["kernels"].get("slab_bwd")
    return 100.0 * k["ideal_s"] / k["time_s"] if k and k["n"] and k["time_s"] > 0 else None
