"""device_idle: 100 (1 - busy / wall) over the traced keyframe cycle (the
whole cycle after the window): busy is the union of the intervals in which
an operation ran on the card, by the profiler's trace."""


def read(ctx):
    t = ctx["traces"].get("cycle")
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t and t["window_s"] > 0 else None
