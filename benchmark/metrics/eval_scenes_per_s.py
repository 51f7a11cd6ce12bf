"""Scenes evaluated per second: every scene the window's calls covered over
the window's whole time, to the end of its last call (host clock)."""


def read(o):
    return o.scenes / o.window_s if o.window_s > 0 and o.calls else None
