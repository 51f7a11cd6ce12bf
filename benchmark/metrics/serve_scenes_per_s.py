"""Scenes served per second in validation: every scene of the window's
evaluations over the window's whole time, to the end of its last
evaluation, whose F1 was read back (host clock)."""


def read(o):
    return o.scenes / o.window_s if o.window_s > 0 and o.calls else None
