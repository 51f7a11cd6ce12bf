"""Set-up seconds: from the process's start of work (before the program is
imported) to the end of the warm-up, which builds every kernel, makes the
inputs and weights and runs every shape the window runs (host clock)."""


def read(o):
    return o.setup_s
