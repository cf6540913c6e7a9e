"""Automatic symbol naming (counterpart of ``mxnet_tpu/name.py``,
reference python/mxnet/name.py NameManager)."""
from __future__ import annotations

import threading


class NameManager:
    """Hands out ``<hint><n>`` names, counting per hint; a ``with`` block
    makes the manager current for the thread."""

    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return "%s%d" % (hint, n)

    def __enter__(self):
        self._old_manager = current()
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager._current.value = self._old_manager


class Prefix(NameManager):
    """Prefixes every name it hands out."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


def current() -> NameManager:
    if not hasattr(NameManager._current, "value"):
        NameManager._current.value = NameManager()
    return NameManager._current.value
