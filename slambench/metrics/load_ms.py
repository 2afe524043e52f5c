"""load_ms: the mean of the program's `frame.load` section over the window
(the dataset read, the device copy and the edge mask, behind the
prefetcher)."""


def read(ctx):
    s = ctx["sections"].get("frame.load")
    return s["mean_ms"] if s and s["n"] else None
