"""map_slab_fill: the live entries over the slab rows of the program's
binnings inside a `kf.*` span over the window (the keyframe event's
extend render, the window's per segment, the visibility passes), in
percent. A program without the slab counts gives nothing."""

from ._slab_fill import fill


def read(ctx):
    return fill(ctx, lambda path: any(k.startswith("kf.") for k in path))
