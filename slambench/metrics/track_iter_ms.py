"""track_iter_ms: the program's `track.dispatch` and `track.readback`
sections over the window, over the tracking iterations the tracker
reported for the window's frames."""


def read(ctx):
    s = ctx["sections"]
    iters = sum(ctx["track_iters"])
    tot = sum(s[k]["total_s"] for k in ("track.dispatch", "track.readback") if k in s)
    return 1e3 * tot / iters if iters and tot else None
