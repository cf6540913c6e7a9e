"""Where the time goes on the generate path, on one CUDA card.

    python3 -m mxnet_tpu_torch.tools.profile_generate [ARM ...]   # repo root

ARM is ``{unpaged|paged}_{f32|int8}_{eager|captured}``, a quantized-weight
arm ``quant_{int8|fp8}_unpaged_f32_captured`` (the decode step of the
model quantized as ``GenerateConfig.quant_weights`` quantizes it, int8
activations) or a speculative arm ``spec_int8_{unpaged|paged}_f32_captured``
(the int8 draft's decode step, the target's verify over W = k + 1
positions, k = ``SERVE_SPEC["spec_tokens"]``; default: all twelve).
Builds the full-width LM that ``chip_smoke.py`` serves
(``tools/lm.py``: same seeded weights, f32 weights, no TF32) at
``SERVE_PAGED``'s configuration (8 slots, capacity 2304; paged: 288
blocks of 16 positions), admits the first six prompts of its traffic
(the five sharers of the system prompt and one unshared prompt, the
joiners sharing and forking when paged), then measures each arm on the
card:

- host-clock ms of one prefill per bucket (unpaged: ``prefill`` of a
  prompt 3 short of the bucket; paged: its cold ``paged_prefill``) and of
  one decode step over all slots, with and without the logits' copy to
  the host (each ending in ``torch.cuda.synchronize()``, median of reps);
- a ``torch.profiler`` window over one 2048-bucket prefill and over ten
  decode steps (each with its logits' copy to the host, as the scheduler
  takes them): device kernel time by kind (the flash kernel, matrix
  products, everything else), the device's busy ms and idle share of the
  window, the kernel launches and the heaviest kernels.

A speculative arm measures its draft step as the decode step and adds host
ms and profiler windows of ten verifies and of ten iterations (k draft
steps and a verify, each with its logits' copy).

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
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "cublas",
                              "nvjet")):
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


ARMS = ["%s_%s_%s" % (kind, kv, how) for kind in ("unpaged", "paged")
        for kv in ("f32", "int8") for how in ("eager", "captured")]
ARMS += ["quant_int8_unpaged_f32_captured", "quant_fp8_unpaged_f32_captured",
         "spec_int8_unpaged_f32_captured", "spec_int8_paged_f32_captured"]


def _profile(fn):
    """Device busy ms by kind, idle share and launches of one window."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
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
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "device_ms_by_kind": by_kind,
            "kernel_launches": int(sum(e.count for e in kernels)),
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def _arm(gen, lm, model, arm):
    """(decode step fn, prefill fn by bucket, notes, verify fn or None) of
    one arm, with the first six prompts of the paged traffic admitted."""
    from mxnet_tpu_torch import quant

    parts = arm.split("_")
    draft = None
    if parts[0] == "quant":
        weight = {"int8": "int8", "fp8": "fp8_e4m3"}[parts[1]]
        model = quant.quantize_decode_model(
            model, quant.QuantConfig(weight_dtype=weight, act_dtype="int8"))
        parts = parts[2:]
    elif parts[0] == "spec":
        draft = quant.quantize_decode_model(
            model, quant.QuantConfig(weight_dtype="int8", act_dtype="int8"))
        parts = parts[2:]
    kind, kv, how = parts
    kv = {"f32": "float32", "int8": "int8"}[kv]
    paged = lm.SERVE_PAGED
    capture = how == "captured"
    window = lm.SERVE_SPEC["spec_tokens"] + 1
    wtok = np.arange(paged["slots"] * window, dtype=np.int64).reshape(
        paged["slots"], window)
    prompts = lm.paged_prompts(lm.LM, paged, lm.SEED)[:6]
    rng = np.random.default_rng(1)
    cold = {b: rng.integers(0, lm.LM["vocab"], b - 3).tolist()
            for b in paged["prefill_buckets"]}
    lengths = np.zeros(paged["slots"], np.int64)
    tokens = np.arange(paged["slots"], dtype=np.int64)
    if kind == "unpaged":
        progs = gen.DecodePrograms(model, paged["slots"],
                                   paged["max_context"],
                                   paged["prefill_buckets"], kv_dtype=kv,
                                   capture=capture, step_model=draft)
        cache = gen.KVCacheManager(progs)
        for slot, p in enumerate(prompts):
            pre = progs.prefill(p)
            progs.admit(cache.k_slab, cache.v_slab, pre[1], pre[2], slot,
                        ks_slab=cache.k_scale, vs_slab=cache.v_scale,
                        ks_new=pre[3] if len(pre) == 5 else None,
                        vs_new=pre[4] if len(pre) == 5 else None)
            lengths[slot] = len(p)

        def step():
            return progs.decode(cache.k_slab, cache.v_slab, lengths, tokens,
                                ks_slab=cache.k_scale, vs_slab=cache.v_scale)

        def prefill(b):
            return progs.prefill(cold[b])[0]

        def verify():
            return progs.verify(cache.k_slab, cache.v_slab, lengths, wtok,
                                ks_slab=cache.k_scale, vs_slab=cache.v_scale)

        if draft is None:
            return step, prefill, {}, None
        progs.enable_verify(window)
        return step, prefill, {}, verify
    progs = gen.PagedDecodePrograms(
        model, paged["slots"], paged["max_context"],
        paged["prefill_buckets"], paged["block_tokens"],
        paged["num_blocks"], kv_dtype=kv, capture=capture, step_model=draft)
    cache = gen.PagedKVCacheManager(progs)
    scales = {"ks_slab": cache.k_scale, "vs_slab": cache.v_scale}
    for p in prompts:
        plan = cache.try_admit(p, p, paged["max_new_tokens"])
        progs.paged_prefill(cache.k_slab, cache.v_slab, plan.table,
                            plan.ctx_len, plan.suffix, plan.fork_src,
                            plan.fork_dst, **scales)
    lengths, tables = cache.step_arrays()

    def step():
        return progs.decode(cache.k_slab, cache.v_slab, tables, lengths,
                            tokens, **scales)

    # cold paged prefills go through a second manager and its own slabs,
    # so they leave the decode state as it is
    spare = gen.PagedKVCacheManager(progs, prefix_share=False)

    def prefill(b):
        plan = spare.try_admit(b, cold[b], 1)
        try:
            return progs.paged_prefill(spare.k_slab, spare.v_slab,
                                       plan.table, 0, plan.suffix, 0, 0,
                                       ks_slab=spare.k_scale,
                                       vs_slab=spare.v_scale)
        finally:
            spare.free(plan.slot)

    def verify():
        return progs.verify(cache.k_slab, cache.v_slab, tables, lengths,
                            wtok, **scales)

    notes = {"blocks_in_use": cache.blocks_total() - cache.blocks_free(),
             "prefix_tokens_saved": cache.prefix_tokens_saved}
    if draft is None:
        return step, prefill, notes, None
    progs.enable_verify(window)
    return step, prefill, notes, verify


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("profile_generate: no CUDA device available", file=sys.stderr)
        return 2
    from mxnet_tpu_torch.serving import generate as gen
    from mxnet_tpu_torch.tools import lm

    arms = list(sys.argv[1:] if argv is None else argv) or ARMS
    unknown = sorted(set(arms) - set(ARMS))
    if unknown:
        print("profile_generate: unknown arm(s) %s; have %s"
              % (unknown, ARMS), file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = lm.LM
    spec = gen.DecodeSpec(num_heads=cfg["heads"], num_kv_heads=cfg["kv_heads"])
    model = gen.DecodeModel.from_arg_params(lm.lm_arg_params(cfg, lm.SEED),
                                            spec)
    gpu = lm.nvidia_smi()
    k = lm.SERVE_SPEC["spec_tokens"]
    for arm in arms:
        step, prefill, notes, verify = _arm(gen, lm, model, arm)
        buckets = lm.SERVE_PAGED["prefill_buckets"]
        for b in buckets:                       # warm every program
            prefill(b)
        for _ in range(3):                      # warm-up calls, capture
            step()
            if verify is not None:
                verify()
        host = {"measure": "host_ms", "arm": arm,
                "prefill_ms": {b: _host_ms(lambda b=b: prefill(b), 5)
                               for b in buckets},
                "decode_step_ms": _host_ms(step, 20),
                "decode_step_with_logits_to_host_ms": _host_ms(
                    lambda: step().cpu(), 20), "gpu": gpu, **notes}
        windows = [("prefill_%d" % buckets[-1], lambda: prefill(buckets[-1])),
                   ("decode_x10", lambda: [step().cpu() for _ in range(10)])]
        if verify is not None:
            def iteration():
                for _ in range(k):
                    step().cpu()
                verify().cpu()

            host.update(verify_ms=_host_ms(verify, 20),
                        verify_with_logits_to_host_ms=_host_ms(
                            lambda: verify().cpu(), 20),
                        iteration_ms=_host_ms(iteration, 10), k=k)
            windows += [("verify_x10",
                         lambda: [verify().cpu() for _ in range(10)]),
                        ("iteration_x10",
                         lambda: [iteration() for _ in range(10)])]
        _emit(host)
        for window, fn in windows:
            _emit(dict({"measure": "profile", "arm": arm,
                        "window": window}, **_profile(fn)))
        del step, prefill, verify, windows
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
