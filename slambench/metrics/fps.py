"""fps: frames tracked and mapped per second, all frames of the window's
whole keyframe cycles over all their time (host clock)."""


def read(ctx):
    return ctx["window"]["fps"]
