"""launches_per_track_iter: every kernel the card ran in the traced
tracked frame (the first frame after the traced cycle that is not a
keyframe), by the profiler's trace, over the tracking iterations of that
frame."""


def read(ctx):
    t = ctx["traces"].get("frame")
    return t["launches"] / t["iters"] if t and t["iters"] else None
