"""kf_ms: the program's `kf.*` sections summed over the window, over the
window's keyframe events."""


def read(ctx):
    n = len(ctx["window"]["keyframes"])
    tot = sum(v["total_s"] for k, v in ctx["sections"].items() if k.startswith("kf."))
    return 1e3 * tot / n if n and tot else None
