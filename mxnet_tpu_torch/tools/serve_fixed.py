"""The fixed-shape serving run the card scripts drive.

``chip_smoke.py`` (its ``serve_fixed`` phase) and
:mod:`mxnet_tpu_torch.tools.resnet_predict_spread` take from here:

- the LM ``Predictor``'s bound shapes (``lm_shapes``: bound at the first,
  reshaped to the others), bench.py's LM with its ``SoftmaxOutput`` head
  (``tools/lm.py``);
- the ``InferenceServer`` in front of bench.py's ResNet-50
  (``tools/resnet.py``): the bucket ladder, the batch former's window, two
  replicas on one card, zero-copy staging, every bucket bound at start;
- its traffic: ``clients`` threads, each sending its share of
  ``requests`` requests one after another, of 1 to 4 images each
  (:func:`request_sizes`, seeded), uniform(-1, 1) pixels
  (:func:`request_images`); then a burst of ``burst`` requests at
  ``burst_timeout_ms``;
- the generate arm: the LM behind the same server class with
  ``decode=GenerateConfig(...)``, its fixed path bound at
  (1, ``decode_example_len``).
"""
from __future__ import annotations

import numpy as np

SERVE_FIXED = {"lm_shapes": ((1, 512), (4, 512), (1, 2048)),
               "buckets": (1, 2, 4, 8, 16, 32), "max_delay_ms": 5.0,
               "replicas": 2, "clients": 8, "requests": 96,
               "rows": (1, 4), "timeout_ms": 60000.0, "burst": 64,
               "burst_timeout_ms": 1.0, "cpu_checks": 2,
               "decode_example_len": 512}
SEED = 0


def request_sizes(fixed, seed=SEED):
    """Rows of each request, uniform in ``fixed["rows"]``, seeded."""
    lo, hi = fixed["rows"]
    rng = np.random.RandomState(seed + 7)
    return [int(r) for r in rng.randint(lo, hi + 1, fixed["requests"])]


def request_images(cfg, sizes, seed=SEED):
    """One f32 array of uniform(-1, 1) images a request, seeded."""
    rng = np.random.RandomState(seed + 8)
    return [rng.uniform(-1, 1, (r,) + tuple(cfg["image"])).astype(np.float32)
            for r in sizes]
