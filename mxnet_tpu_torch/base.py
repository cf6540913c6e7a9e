"""Base utilities: the framework's error type and attribute parsing.

Counterpart of ``mxnet_tpu/base.py`` (reference: python/mxnet/base.py:71).
"""
from __future__ import annotations

import ast
from typing import Any


class MXNetError(RuntimeError):
    """Error raised by the framework."""


def coerce_attr(value: Any) -> Any:
    """Coerce a reference-style string attribute ("(2,2)", "true", "0.9")
    into a Python value; native Python values pass through unchanged, so
    both spellings of an operator's kwargs are accepted."""
    if not isinstance(value, str):
        return value
    s = value.strip()
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return value
