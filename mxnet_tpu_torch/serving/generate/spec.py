"""Host-side token sampling (f64 numpy), shared by every decode path.

Counterpart of the sampling helpers of ``mxnet_tpu/serving/generate/
spec.py``, kept bitwise: greedy is ``argmax``, sampling is one inverse-CDF
draw from an f64 softmax with the stream's own ``RandomState``.
Speculative decoding (``SpecDecoder``) is not ported yet.
"""
from __future__ import annotations

import numpy as np


def _softmax64(logits, temperature: float) -> np.ndarray:
    """f64 softmax on the host — the one place sampling probabilities are
    computed."""
    z = np.asarray(logits, np.float64) / max(float(temperature), 1e-8)
    z = z - z.max()
    e = np.exp(z)
    return e / e.sum()


def _draw(probs: np.ndarray, rng) -> int:
    """One inverse-CDF draw (clamped against fp round-off in the cumsum
    tail)."""
    u = rng.random_sample()
    idx = int(np.searchsorted(np.cumsum(probs), u, side="right"))
    return min(idx, len(probs) - 1)


def sample_token(logits, temperature: float, rng) -> int:
    """Greedy argmax at temperature 0 (or without an rng), else one draw
    from the f64 softmax."""
    if temperature <= 0.0 or rng is None:
        return int(np.asarray(logits).argmax())
    return _draw(_softmax64(logits, temperature), rng)
