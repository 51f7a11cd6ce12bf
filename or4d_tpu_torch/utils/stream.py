"""One-step lookahead pipelining for device-streaming loops (port of
``or4d_tpu/utils/stream.py``).

CUDA launches are asynchronous: a forward returns once its kernels are
queued, and only a host pull waits for them. A loop that queues an item and
then pulls its results leaves the card idle during every pull. Dispatching
item i+1's device work before consuming item i's results overlaps uploads
and compute with the pull while keeping at most two items' device buffers
live. For the overlap to be real, ``dispatch`` copies its results to pinned
host memory without blocking and records an event, and ``consume`` waits on
that event only (a plain ``.cpu()`` would wait for item i+1's work too,
which sits behind it on the same stream).
"""

from __future__ import annotations

from collections.abc import Callable, Iterable


def lookahead(items: Iterable, dispatch: Callable, consume: Callable) -> list:
    """For each item: ``work = dispatch(item)`` (queued device work), then
    ``consume(work)``, with item i+1 dispatched before item i is consumed.
    Returns ``[consume(dispatch(item)) for item in items]`` in item order."""
    out = []
    pending = None
    for item in items:
        current = dispatch(item)
        if pending is not None:
            out.append(consume(pending))
        pending = current
    if pending is not None:
        out.append(consume(pending))
    return out
