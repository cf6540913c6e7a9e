"""Serving: the continuous-batching generate path (``serving.generate``).
The fixed-shape batcher/InferenceServer path is not ported yet."""
from .batcher import ServingError

__all__ = ["ServingError"]
