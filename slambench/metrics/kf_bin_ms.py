"""kf_bin_ms: the stream time of the program's `bin` spans inside a `kf.*`
span over the window (the keyframe event's binnings: the extend render,
the window's per segment, the visibility passes), over the window's
keyframe events, as `kf_ms`. A program without span paths gives
nothing."""


def read(ctx):
    paths = ctx["sections"].get("bin", {}).get("paths")
    n = len(ctx["window"]["keyframes"])
    if not paths or not n:
        return None
    tot = sum(v["total_s"] for p, v in paths.items()
              if any(k.startswith("kf.") for k in p.split("/")))
    return 1e3 * tot / n
