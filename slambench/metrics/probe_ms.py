"""probe_ms: the stream time of the program's `probe` spans over the window
(the slab-capacity probes after each event that grows the map, and the
tracker's backstop probes), over the window's keyframe events, as
`kf_ms`. A program without probe spans gives nothing."""


def read(ctx):
    probe = ctx["sections"].get("probe")
    n = len(ctx["window"]["keyframes"])
    if not probe or not probe.get("n") or not n:
        return None
    return 1e3 * probe["total_s"] / n
