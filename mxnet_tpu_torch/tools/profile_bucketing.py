"""Where the time goes in one bucketed LSTM LM step, on one CUDA card.

    python3 -m mxnet_tpu_torch.tools.profile_bucketing   # from the repo root

Sets up the run of ``chip_smoke.py``'s bucketing phase
(``tools/lstm_bucketing.py``: ``BucketingModule`` over the fused 2-layer
LSTM LM, vocab 10000, embed = hidden = 512, dropout 0.5, batch 32, f32,
no TF32, SGD momentum, ``Perplexity(ignore_label=0)``), takes one batch of
each bucket and, for each, warms two steps, then measures on the card:

- host-clock time of the step's stages — forward (is_train, with the
  batch's copy to the card), backward, the 4 parameter updates, the
  Perplexity update — each ending in ``torch.cuda.synchronize()``, median
  of 3 steps;
- a ``torch.profiler`` window over one whole step: device kernel time and
  launches by kind (``profile_lstm``'s kinds, and the dropout masks'
  Philox draws as "rng"), and the device's busy and idle share of the
  window.

Prints one JSON line per bucket; exits non-zero without a card.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from .profile_lstm import KINDS as LSTM_KINDS

KINDS = (("rng", ("philox", "distribution", "uniform", "bernoulli")),) \
    + LSTM_KINDS


def _kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_bucketing: no CUDA device available",
              file=sys.stderr)
        return 2
    from mxnet_tpu_torch.tools import lm
    from mxnet_tpu_torch.tools import lstm_bucketing as lb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = lb.BUCKETING
    mod, init = lb.bucketing_module(cfg, None, cfg["dropout"], cfg["batch"])
    args = lb.fit_args(cfg, init)
    mod.init_optimizer(optimizer=args["optimizer"],
                       optimizer_params=args["optimizer_params"])
    ppl = args["eval_metric"]
    batches = lb.pick_batches(lb.bucket_iter(cfg, cfg["batch"], lb.SEED + 1),
                              cfg["buckets"]).batches
    for batch in batches:
        profile(mod, batch, ppl, lm.nvidia_smi())
    return 0


def profile(mod, batch, ppl, gpu):
    """Stage times and a profiled step of ``mod`` on ``batch``."""
    stages = (("forward", lambda: mod.forward(batch, is_train=True)),
              ("backward", mod.backward), ("update", mod.update),
              ("metric", lambda: mod.update_metric(ppl, batch.label)))
    for _ in range(2):                               # warm
        for _name, fn in stages:
            fn()
    times = {name: [] for name, _ in stages}
    for _ in range(3):
        for name, fn in stages:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _name, fn in stages:
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind, launches = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = _kind(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + e.self_device_time_total / 1e3
        launches[k] = launches.get(k, 0) + e.count
    busy = sum(by_kind.values())
    print(json.dumps({
        "measure": "bucketing_step", "bucket": batch.bucket_key,
        "batch": batch.data[0].shape[0],
        "stage_ms": {k: float(np.median(v)) for k, v in times.items()},
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / wall_ms,
        "device_ms_by_kind": by_kind, "kernel_launches": launches,
        "gpu": gpu}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
