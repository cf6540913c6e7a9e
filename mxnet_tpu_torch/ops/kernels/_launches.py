"""Launch counters that stay exact when a CUDA graph replays the launches.

Every kernel wrapper counts its launches in a ``launches`` attribute,
incremented in Python where it launches; a wrapper whose kernel has one
instantiation per type counts through :func:`launched`, which also counts
by type in ``launches_by_dtype``. A captured graph replays its
kernels without running that Python, and capturing it runs the Python
but launches nothing. So whoever captures takes every counter before and
after the capture, takes the difference back out (a capture is not a
launch) and adds it once for each replay:

    delta = capture(lambda: graph_ctx(body))   # counters as before
    ...
    graph.replay(); replayed(delta)            # each replay counts once

:func:`counted` registers a wrapper (a function or an object such as an
``mx.rtc`` kernel) and sets its counts to 0.
"""
from __future__ import annotations

import weakref

_COUNTERS = weakref.WeakSet()


def counted(obj):
    """Register ``obj`` as a launch counter (``obj.launches = 0``,
    ``obj.launches_by_dtype = {}``)."""
    reset(obj)
    _COUNTERS.add(obj)
    return obj


def reset(obj):
    """Set ``obj``'s counts to 0."""
    obj.launches = 0
    obj.launches_by_dtype = {}


def launched(obj, dtype):
    """Count one launch of ``obj``'s kernel on operands of ``dtype``."""
    obj.launches += 1
    key = str(dtype).replace("torch.", "")
    obj.launches_by_dtype[key] = obj.launches_by_dtype.get(key, 0) + 1


def snapshot():
    """{counter: launches, (counter, type): launches of that type} of every
    registered counter."""
    out = {}
    for c in list(_COUNTERS):
        out[c] = c.launches
        for key, n in c.launches_by_dtype.items():
            out[(c, key)] = n
    return out


def since(before):
    """The entries of :func:`snapshot` that moved since ``before``, as
    differences."""
    out = {}
    for k, n in snapshot().items():
        d = n - before.get(k, 0)
        if d:
            out[k] = d
    return out


def replayed(delta, times=1):
    """Add ``delta`` (from :func:`capture`) ``times`` times."""
    for k, d in delta.items():
        if isinstance(k, tuple):
            c, key = k
            n = c.launches_by_dtype.get(key, 0) + d * times
            if n:
                c.launches_by_dtype[key] = n
            else:
                c.launches_by_dtype.pop(key, None)
        else:
            k.launches += d * times


def capture(record):
    """Run ``record()`` (a graph capture: the wrappers run and count, the
    card launches nothing), restore every counter, and return what one
    replay of the recording launches, for :func:`replayed`."""
    before = snapshot()
    try:
        record()
    finally:
        delta = since(before)
        replayed(delta, -1)
    return delta
