"""track_ms: from a frame handed to SLAM.track to its pose on the host,
summed over the frames of the window's whole keyframe cycles, over their
count (host clock)."""


def read(ctx):
    return ctx["window"]["track_ms"]
