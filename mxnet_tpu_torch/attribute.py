"""Attribute scoping (counterpart of ``mxnet_tpu/attribute.py``, reference
python/mxnet/attribute.py AttrScope): ``with AttrScope(key='value'):``
tags every symbol created inside the block."""
from __future__ import annotations

import threading


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        self._old_scope = None
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("Attributes need to be strings")
        self._attr = kwargs

    def get(self, attr):
        """The scope's attributes updated with ``attr`` (a new dict)."""
        ret = dict(self._attr)
        if attr:
            ret.update(attr)
        return ret

    def __enter__(self):
        self._old_scope = current()
        attr = dict(self._old_scope._attr)
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        AttrScope._current.value = self._old_scope


def current() -> AttrScope:
    if not hasattr(AttrScope._current, "value"):
        AttrScope._current.value = AttrScope()
    return AttrScope._current.value
