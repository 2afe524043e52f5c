"""track_iters: the mean of the tracking iterations the tracker reported
for the window's frames (its convergence exit sets them)."""


def read(ctx):
    it = ctx["track_iters"]
    return sum(it) / len(it) if it else None
