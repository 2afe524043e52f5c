"""track_bin_ms: the stream time of the program's `bin` spans inside
`track.dispatch` over the window (the tracker's binnings: one a segment
and its final render's), over the window's tracked frames. A program
without span paths gives nothing."""


def read(ctx):
    s = ctx["sections"]
    paths = s.get("bin", {}).get("paths")
    n = s.get("track.dispatch", {}).get("n")
    if not paths or not n:
        return None
    tot = sum(v["total_s"] for p, v in paths.items() if "track.dispatch" in p.split("/"))
    return 1e3 * tot / n
