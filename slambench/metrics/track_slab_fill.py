"""track_slab_fill: the live entries over the slab rows of the program's
binnings inside `track.dispatch` over the window (one a tracking segment
and its final render's), in percent. A program without the slab counts
gives nothing."""

from ._slab_fill import fill


def read(ctx):
    return fill(ctx, lambda path: "track.dispatch" in path)
