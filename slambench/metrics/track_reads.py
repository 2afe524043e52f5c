"""track_reads: the program's `host_read` count over the window's frames
outside every `kf.*` span (the tracker's exit reads, its readback, the
keyframe decision), over the window's tracked frames. A program without
host-read counts gives nothing."""


def read(ctx):
    s = ctx["sections"]
    reads = s.get("host_read", {}).get("paths")
    n = s.get("track.dispatch", {}).get("n")
    if reads is None or not n:
        return None
    count = sum(v["n"] for p, v in reads.items()
                if p.split("/")[0] == "frame" and not any(k.startswith("kf.") for k in p.split("/")))
    return count / n
