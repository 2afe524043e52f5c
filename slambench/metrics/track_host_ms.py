"""track_host_ms: the host time of the program's `track.dispatch` spans
over the window less the time the host was blocked in the `host_read`s
inside them, over the window's tracking iterations: the host's own
dispatch work an iteration (`track_iter_ms` less this is the wait). A
program without host times and host reads gives nothing."""


def read(ctx):
    s = ctx["sections"]
    disp, reads = s.get("track.dispatch", {}), s.get("host_read", {}).get("paths")
    iters = sum(ctx["track_iters"])
    if "host_s" not in disp or reads is None or not iters:
        return None
    blocked = sum(v["total_s"] for p, v in reads.items() if "track.dispatch" in p.split("/"))
    return 1e3 * (disp["host_s"] - blocked) / iters
