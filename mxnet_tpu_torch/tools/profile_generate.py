"""Where the time goes on the generate path, on one CUDA card.

    python3 -m mxnet_tpu_torch.tools.profile_generate     # from the repo root

Builds the full-width LM that ``chip_smoke.py`` serves (``tools/lm.py``:
same seeded weights, f32, no TF32), warms every program, then measures on the card:

- host-clock time of one prefill per bucket and of one decode step over
  all slots (each ending in ``torch.cuda.synchronize()``, median of reps);
- a ``torch.profiler`` window over one 2048-bucket prefill and ten decode
  steps: device kernel time by kind (the flash kernel, matrix products,
  everything else), the device's busy and idle share of the window, and
  the heaviest kernels.

Prints one JSON line per measurement; exits non-zero without a card.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch


def _emit(obj):
    print(json.dumps(obj), flush=True)


# the port's kernels by the name of their __global__ function (the flash
# forward: one per type, csrc/flash_attention_fwd.cu; the backward: a dQ
# and a dK/dV kernel per type, csrc/flash_attention_bwd.cu)
KERNELS = {"flash_fwd_wgmma_kernel": "flash_attention_fwd",
           "flash_fwd_f32_kernel": "flash_attention_fwd",
           "flash_bwd_dq_wgmma_kernel": "flash_attention_bwd",
           "flash_bwd_dkv_wgmma_kernel": "flash_attention_bwd",
           "flash_bwd_dq_f32_kernel": "flash_attention_bwd",
           "flash_bwd_dkv_f32_kernel": "flash_attention_bwd",
           "sgd_mom_kernel": "sgd_mom_update",
           "adam_kernel": "adam_update"}


def _kind(name: str) -> str:
    for fn, kind in KERNELS.items():
        if fn in name:
            return kind
    low = name.lower()
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "cublas")):
        return "matmul"
    return "other"


def _host_ms(fn, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_generate: no CUDA device available", file=sys.stderr)
        return 2
    from mxnet_tpu_torch.serving import generate as gen
    from mxnet_tpu_torch.tools import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, serve = lm.LM, lm.SERVE
    spec = gen.DecodeSpec(num_heads=cfg["heads"], num_kv_heads=cfg["kv_heads"])
    model = gen.DecodeModel.from_arg_params(lm.lm_arg_params(cfg, lm.SEED),
                                            spec)
    progs = gen.DecodePrograms(model, serve["slots"], serve["max_context"],
                               serve["prefill_buckets"])
    k_slab, v_slab = progs.fresh_slabs()
    rng = np.random.default_rng(1)
    prompts = {b: rng.integers(0, cfg["vocab"], b - 3).tolist()
               for b in progs.buckets}
    for b in progs.buckets:                       # warm every program
        _last, k_new, v_new = progs.prefill(prompts[b])
        progs.admit(k_slab, v_slab, k_new, v_new, 0)
    lengths = np.array([2045, 600, 300, 100][:progs.slots], np.int64)
    tokens = np.arange(progs.slots, dtype=np.int64)

    def step():
        return progs.decode(k_slab, v_slab, lengths, tokens)

    for _ in range(3):
        step()
    _emit({"measure": "host_ms",
           "prefill_ms": {b: _host_ms(lambda b=b: progs.prefill(prompts[b]),
                                      5) for b in progs.buckets},
           "decode_step_ms": _host_ms(step, 20),
           "decode_step_with_logits_to_host_ms": _host_ms(
               lambda: step().cpu(), 20),
           "gpu": lm.nvidia_smi()})

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for window, fn in (("prefill_2048", lambda: progs.prefill(
            prompts[progs.buckets[-1]])),
            ("decode_x10", lambda: [step().cpu() for _ in range(10)])):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        by_kind = {}
        for e in kernels:
            k = _kind(e.key)
            by_kind[k] = by_kind.get(k, 0.0) + e.self_device_time_total / 1e3
        busy = sum(by_kind.values())
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        _emit({"measure": "profile", "window": window, "wall_ms": wall_ms,
               "device_busy_ms": busy,
               "device_idle_share": 1.0 - busy / wall_ms,
               "device_ms_by_kind": by_kind,
               "kernel_launches": int(sum(e.count for e in kernels)),
               "top_kernels": [{"name": e.key[:80], "count": e.count,
                                "ms": e.self_device_time_total / 1e3}
                               for e in top]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
