"""Where the time goes in one LSTM LM ``Module.fit`` step, on one CUDA card.

    python3 -m mxnet_tpu_torch.tools.profile_lstm        # from the repo root

Sets up the run of ``chip_smoke.py``'s lstm phase
(``tools/lstm_lm.py:lstm_setup``: the fused 2-layer LSTM LM, vocab 10000,
embed = hidden = 512, seq 35, batch 128, f32, no TF32, Xavier from the
seed, plain SGD lr 0.5), and then the same model with the custom phase's
``rtc_softmax`` head (``tools/rtc_softmax.py``); for each head it warms two
steps, then measures on the card:

- host-clock time of the step's stages — forward (is_train, with the
  batch's copy to the card), backward, the 4 parameter updates, the
  Perplexity update — each ending in ``torch.cuda.synchronize()``, median
  of 3 steps;
- a ``torch.profiler`` window over one whole step: device kernel time and
  launches by kind (the port's lstm_step, matrix products, softmax,
  embedding gather / scatter, sgd, the elementwise and reduction kernels
  of the plain recompute in the backward, copies, everything else), the
  device's busy and idle share of the window, the ``lstm_step`` launches
  the wrapper counted, and the heaviest kernels.

Kinds come from kernel names; the heaviest kernels are printed so the
split can be read. Prints one JSON line per measurement; exits non-zero
without a card.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

# (kind, substrings of the lower-cased kernel name), first match wins
KINDS = (
    ("lstm_step", ("lstm_step", "lstm_f32_kernel", "lstm_wgmma_kernel",
                   "lstm_simt_kernel")),
    ("rtc_softmax", ("rtc_softmax",)),
    ("matmul", ("gemm", "gemv", "cublas", "cutlass", "xmma", "splitk",
                "nvjet")),
    ("softmax", ("softmax",)),
    ("embedding", ("embedding", "index", "scatter", "gather")),
    ("sgd", ("sgd",)),
    ("copy", ("memcpy", "memset", "copy")),
    ("elementwise/reduce", ("elementwise", "reduce", "sigmoid", "tanh",
                            "mul", "add", "fill", "cat", "flip")),
)


def _kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def _emit(obj):
    print(json.dumps(obj), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_lstm: no CUDA device available", file=sys.stderr)
        return 2
    from mxnet_tpu_torch.tools import lstm_lm, rtc_softmax

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = lstm_lm.LSTM_LM
    profile(cfg, "SoftmaxOutput", None)
    profile(cfg, "rtc_softmax", rtc_softmax.lstm_rtc_symbol(cfg))
    return 0


def profile(cfg, head, symbol):
    """Stage times and a profiled step of the LSTM LM with ``symbol``
    (None: the model's own SoftmaxOutput head), each line tagged
    ``head``."""
    from mxnet_tpu_torch.ops.kernels import lstm as kl
    from mxnet_tpu_torch.tools import lm, lstm_lm

    mod, it, init = lstm_lm.lstm_setup(cfg, cfg["batch"], 1, symbol=symbol)
    args = lstm_lm.fit_args(cfg, init)
    mod.init_optimizer(optimizer=args["optimizer"],
                       optimizer_params=args["optimizer_params"])
    batch = next(iter(it))
    ppl = args["eval_metric"]

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
    _emit({"measure": "host_ms", "head": head, "batch": cfg["batch"],
           "seq": cfg["seq"],
           "stage_ms": {k: float(np.median(v)) for k, v in times.items()},
           "gpu": lm.nvidia_smi()})

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    kl.lstm_step.launches = 0
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _name, fn in stages:
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kind, launches = {}, {}
    for e in kernels:
        k = _kind(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + e.self_device_time_total / 1e3
        launches[k] = launches.get(k, 0) + e.count
    busy = sum(by_kind.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    _emit({"measure": "profile", "head": head, "window": "fit_step",
           "wall_ms": wall_ms,
           "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall_ms,
           "device_ms_by_kind": by_kind, "kernel_launches": launches,
           "lstm_step_launches": kl.lstm_step.launches,
           "top_kernels": [{"name": e.key[:100], "kind": _kind(e.key),
                            "count": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in top]})


if __name__ == "__main__":
    sys.exit(main())
