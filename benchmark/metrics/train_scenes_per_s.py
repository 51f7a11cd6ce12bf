"""Scenes trained on per second: the window's steps' scenes over the window's
whole time, to the end of its last step, whose loss was read back (host
clock)."""


def read(o):
    return o.scenes / o.window_s if o.window_s > 0 and o.calls else None
