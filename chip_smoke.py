#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises (non-zero exit):

1. ``build``   — build every CUDA kernel from ``mxnet_tpu_torch/ops/kernels/
   csrc`` with nvcc for sm_90a (seconds, ptxas report, card name + limit).
2. ``kernel``  — each kernel against its plain PyTorch version on the card
   at the serving path's shapes, f32 and bf16, then timed (CUDA events,
   median) beside the plain version, one PyTorch library call and the
   card's bound.
3. ``serve``   — the continuous-batching generate path at full width (the
   GQA decoder LM of ``bench.py``: d 2048, 16 heads, 4 kv heads, ffn 8192,
   vocab 10000, bench.py's own 4 layers (not cut), seeded random weights,
   f32; ``mxnet_tpu_torch/tools/lm.py``): six
   prompts through ``DecodeScheduler`` with four slots, so admissions
   happen mid-flight. Checks every stream, the kernel's launch count, and
   first-token logits against the port's plain path on the CPU.
4. ``kernels`` — one line per the port's kernel table.

Then the card's ``nvidia-smi`` name/power-limit line and, last, the
``{"ok": true, "device": ...}`` line. Exits non-zero without a CUDA card.
"""
import json
import os
import sys
import threading
import time

import numpy as np

from mxnet_tpu_torch.tools.lm import LM, SERVE, SEED, lm_arg_params, \
    nvidia_smi

H100 = {"bf16_flops": 989e12, "f32_flops": 67e12, "bytes_per_s": 3.35e12}
FA_SRC = "mxnet_tpu_torch/ops/kernels/csrc/flash_attention_fwd.cu"
FA_REPLACES = "mxnet_tpu/ops/pallas/flash_attention.py:259"
# (atol, rtol); bf16 outputs differ by an ulp of |O| (rtol), while atol
# stays below |O| ~ sqrt(e / T) of the long rows
TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-3, 2e-2)}


def emit(obj):
    print(json.dumps(obj), flush=True)


# --- bounds and timing -------------------------------------------------------
def attention_bound(b, h, hkv, tq, tk, d, causal, dtype):
    """Least time (ms) for one forward on the card, and what bounds it:
    4*D flops per visible (query, key) pair and head (QK^T and PV, the
    causal count exact), and q/k/v read plus o written once each."""
    if causal:
        off = tk - tq
        pairs = int(np.minimum(tk, np.arange(tq) + off + 1).sum())
    else:
        pairs = tq * tk
    flops = 4 * b * h * d * pairs
    item = 4 if dtype == "float32" else 2
    nbytes = item * (2 * b * h * tq * d + 2 * b * hkv * tk * d)
    peak = H100["f32_flops"] if dtype == "float32" else H100["bf16_flops"]
    t_ops, t_bytes = flops / peak, nbytes / H100["bytes_per_s"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(torch, fn, reps=30, warmup=3):
    """Median of ``reps`` single-call CUDA-event timings."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# --- phases ------------------------------------------------------------------
def phase_build():
    from mxnet_tpu_torch.ops.kernels import _build

    t0 = time.time()
    paths = _build.build_all()
    emit({"phase": "build", "seconds": time.time() - t0,
          "libraries": {k: os.path.relpath(v) for k, v in paths.items()},
          "nvcc": _build.nvcc(),
          "ptxas": {k: [ln for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in _build.build_log.items()},
          "gpu": nvidia_smi()})


def _qkv(torch, b, h, hkv, tq, tk, d, dtype, gen, heads_major=True):
    """Seeded q/k/v; ``heads_major=False`` gives (B, T, H, D) storage seen
    through ``transpose(1, 2)``, the strided views prefill passes."""
    dt = getattr(torch, dtype)

    def mk(heads, t):
        if heads_major:
            return torch.randn(b, heads, t, d, generator=gen,
                               device="cuda").to(dt)
        return torch.randn(b, t, heads, d, generator=gen,
                           device="cuda").to(dt).transpose(1, 2)

    return mk(h, tq), mk(hkv, tk), mk(hkv, tk)


def phase_kernel(torch):
    """Flash forward: kernel vs plain on the card, then timings."""
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = []     # (b, h, hkv, tq, tk, d, causal, dtype, lse, heads_major)
    for dtype in ("float32", "bfloat16"):
        for t in (128, 512, 1000, 2048):
            cases.append((1, 16, 4, t, t, 128, True, dtype, t == 1000, True))
        cases.append((1, 16, 4, 2048, 2048, 128, True, dtype, False, False))
        cases.append((1, 16, 16, 512, 512, 128, False, dtype, True, True))
        cases.append((1, 16, 4, 300, 1000, 128, True, dtype, True, True))
        cases.append((2, 8, 2, 777, 777, 64, True, dtype, True, True))
    results, worst = [], {}
    for b, h, hkv, tq, tk, d, causal, dtype, with_lse, major in cases:
        q, k, v = _qkv(torch, b, h, hkv, tq, tk, d, dtype, gen, major)
        got = fa.flash_attention(q, k, v, causal=causal, return_lse=with_lse)
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        return_lse=with_lse)
        torch.cuda.synchronize()
        pairs = zip(got, want) if with_lse else [(got, want)]
        errs = []
        atol, rtol = TOL[dtype]
        for g, w in pairs:
            torch.testing.assert_close(g.float(), w.float(),
                                       atol=atol, rtol=rtol)
            errs.append(float((g.float() - w.float()).abs().max()))
        results.append({"shape": [b, h, hkv, tq, tk, d], "causal": causal,
                        "dtype": dtype, "lse": with_lse,
                        "layout": "bhtd" if major else "bthd view",
                        "atol": atol, "rtol": rtol, "max_abs_err": errs})
        worst[dtype] = max(worst.get(dtype, 0.0), max(errs))

    timings = {}
    for dtype in ("bfloat16", "float32"):
        b, h, hkv, t, d = 1, 16, 4, 2048, 128
        q, k, v = _qkv(torch, b, h, hkv, t, t, d, dtype, gen)
        bound_ms, bound_by = attention_bound(b, h, hkv, t, t, d, True, dtype)
        timings[dtype] = {
            "shape": [b, h, hkv, t, t, d], "causal": True,
            "ms": time_ms(torch, lambda: fa.flash_attention(
                q, k, v, causal=True)),
            "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, causal=True)),
            "library_ms": time_ms(torch, _sdpa(torch, q, k, v)),
            "bound_ms": bound_ms, "bound_by": bound_by}
    emit({"phase": "kernel", "kernel": "flash_attention_fwd",
          "cases": results, "max_abs_err": worst, "timings": timings})
    return worst, timings


def _sdpa(torch, q, k, v):
    """The library yardstick: one scaled_dot_product_attention call (GQA
    native from torch 2.5; before that the kv heads are repeated up front,
    outside the timed call). Timed only; the port never calls it."""
    F = torch.nn.functional
    major, minor = (int(x) for x in torch.__version__.split(".")[:2])
    if (major, minor) >= (2, 5):
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
    g = q.shape[1] // k.shape[1]
    kr, vr = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    return lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True)


def phase_serve(cfg=LM, serve=SERVE, device=None, ref_device="cpu",
                seed=SEED):
    """The generate path end to end. ``device`` None = the card (the
    port's default); the reference prefill runs on ``ref_device``, where
    flash_attention takes its plain version."""
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.serving import generate as gen

    params = lm_arg_params(cfg, seed)
    spec = gen.DecodeSpec(num_heads=cfg["heads"],
                          num_kv_heads=cfg["kv_heads"])
    model = gen.DecodeModel.from_arg_params(params, spec, device=device)
    config = gen.GenerateConfig(
        num_heads=cfg["heads"], num_kv_heads=cfg["kv_heads"],
        slots=serve["slots"], max_context=serve["max_context"],
        prefill_buckets=serve["prefill_buckets"],
        max_new_tokens=serve["max_new_tokens"], eos_id=None, capture=False,
        paged=False, kv_dtype="f32", quant_weights="", spec=False)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg["vocab"], n).tolist()
               for n in serve["prompt_lens"]]
    sched = gen.DecodeScheduler(model, config)
    sched.start()
    records = []
    try:
        fa.flash_attention.launches = 0
        t0 = time.monotonic()
        streams = [sched.submit(p) for p in prompts]
        threads = []
        for s in streams:
            rec = {"stream": s, "times": [], "tokens": []}
            records.append(rec)

            def consume(rec=rec):
                for tok in rec["stream"]:
                    rec["times"].append(time.monotonic())
                    rec["tokens"].append(tok)

            th = threading.Thread(target=consume, daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=600)
        wall = time.monotonic() - t0
        launches = fa.flash_attention.launches
        stats = sched.stats()
    finally:
        sched.stop()
    want = serve["max_new_tokens"]
    for rec, th in zip(records, threads):
        s = rec["stream"]
        if th.is_alive() or s.finish_reason != "max_tokens" \
                or len(rec["tokens"]) != want:
            raise RuntimeError("stream of %d prompt tokens ended %r with %d "
                               "tokens" % (s.prompt_len, s.finish_reason,
                                           len(rec["tokens"])))
    expected = len(prompts) * cfg["layers"]
    if launches != expected:
        raise RuntimeError("flash kernel ran %d times in the serve phase, "
                           "want %d" % (launches, expected))

    # first-token logits: the served program vs the port's plain path on
    # the reference device, same numpy weights
    ref_model = gen.DecodeModel.from_arg_params(params, spec,
                                                device=ref_device)
    ref_progs = gen.DecodePrograms(ref_model, 1, serve["max_context"],
                                   serve["prefill_buckets"])
    checks = []
    for n in serve["check_lens"]:
        i = serve["prompt_lens"].index(n)
        got = sched.programs.prefill(prompts[i])[0].float().cpu()
        ref = ref_progs.prefill(prompts[i])[0].float().cpu()
        err = float((got - ref).abs().max())
        tok_ref = int(ref.argmax())
        if err > 1e-3 or records[i]["tokens"][0] != tok_ref:
            raise RuntimeError(
                "prompt %d: first-token logits differ by %g from the plain "
                "path (token %d vs %d)" % (n, err, records[i]["tokens"][0],
                                           tok_ref))
        checks.append({"prompt_len": n, "max_abs_err": err,
                       "token": tok_ref})
    gaps = [b - a for rec in records
            for a, b in zip(rec["times"], rec["times"][1:])]
    total = sum(len(rec["tokens"]) for rec in records)
    result = {"phase": "serve", "requests": len(prompts),
              "prompt_lens": list(serve["prompt_lens"]),
              "ttft_ms": [(rec["times"][0] - rec["stream"].submitted) * 1e3
                          for rec in records],
              "decode_ms_per_step": float(np.median(gaps)) * 1e3,
              "tokens_per_s": total / wall, "wall_s": wall,
              "steps": stats["steps"], "flash_launches": launches,
              "first_token_check": checks}
    emit(result)
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # the reference products run in full f32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    worst, timings = phase_kernel(torch)
    launches = phase_serve()
    t = timings["bfloat16"]
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda", "source": FA_SRC,
        "replaces": FA_REPLACES, "launches": launches,
        "max_abs_err": max(worst.values()), "max_err": worst,
        "dtype": "bfloat16", "shape": t["shape"], "ms": t["ms"],
        "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "float32": timings["float32"]}]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
