"""Time the flash forward with parts of its work taken out, on the card.

    python3 -m mxnet_tpu_torch.tools.flash_fwd_ablate    # from the repo root

Each variant is ``ops/kernels/csrc/flash_attention_fwd.cu`` with a few text
edits (:data:`VARIANTS`): the bf16 kernel without its second P V product
(``lo``), without the online softmax, or without both; the f32 kernel
without its S = Q K^T loop or its P V loop. A variant's O is wrong: it only
shows what the part it drops costs. The variants are built with the port's
nvcc flags into ``mxnet_tpu_torch/_build/ablate/`` (one nvcc each, all
started together), launched through the wrapper's own C entry, and timed
by the profiler's device time beside ``scaled_dot_product_attention``'s, at
the serve shape (1, 16, 4, 2048, 2048, 128) and the train shape (4, ...),
causal, in the (B, T, H, D)-storage views both paths pass. Prints one JSON
line per (type, shape): each variant's device ms and SDPA's.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import shutil
import subprocess

import numpy as np
import torch

from ..ops.kernels import _build
from ..ops.kernels import flash_attention as fa

SYMBOL = "mxtt_flash_attention_fwd"
#: (b, h, hkv, t, d): chip_smoke.py's serve and train timing shapes
SHAPES = {"serve": (1, 16, 4, 2048, 128), "train": (4, 16, 4, 2048, 128)}

_NO_LO = [("      hopper::wgmma_rs_m64n128k16_tb(o, lo[kc], dv);\n", ""),
          ("      hopper::wgmma_rs_m64n64k16_tb(o, lo[kc], dv);\n", "")]
_NO_SOFTMAX = [("float& a0, float& a1) {\n",
                "float& a0, float& a1) {\n  a0 = a1 = 1.f;\n  return;\n")]
#: variant -> (the type whose kernel it changes, [(text, replacement)]):
#: each text occurs exactly once in the source
VARIANTS = {
    "bf16_base": ("bfloat16", []),
    "bf16_no_lo": ("bfloat16", _NO_LO),
    "bf16_no_softmax": ("bfloat16", _NO_SOFTMAX),
    "bf16_no_lo_no_softmax": ("bfloat16", _NO_LO + _NO_SOFTMAX),
    "f32_base": ("float32", []),
    "f32_no_s": ("float32", [("for (int d = 0; d < D; d += 4) {",
                              "for (int d = 0; d < 0; d += 4) {")]),
    "f32_no_pv": ("float32", [("for (int kk = 0; kk < BK; ++kk) {",
                               "for (int kk = 0; kk < 0; ++kk) {")]),
}


def variant_source(name: str) -> str:
    """The forward's source with variant ``name``'s edits; raises if an
    edit's text does not occur exactly once (the source moved on)."""
    with open(os.path.join(_build.CSRC, fa._NAME + ".cu")) as f:
        text = f.read()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise ValueError("variant %s: %r occurs %d times in the source"
                             % (name, old, text.count(old)))
        text = text.replace(old, new)
    return text


def build(names):
    """Build the variants ``names``; returns name -> (library path, the
    nvcc/ptxas log)."""
    procs, out = [], {}
    for name in names:
        d = os.path.join(_build.BUILD_DIR, "ablate", name)
        os.makedirs(d, exist_ok=True)
        for header in _build.inputs(fa._NAME)[1:]:
            shutil.copy(os.path.join(_build.CSRC, header), d)
        src = os.path.join(d, fa._NAME + ".cu")
        with open(src, "w") as f:
            f.write(variant_source(name))
        lib = os.path.join(d, fa._NAME + ".so")
        procs.append((name, lib, subprocess.Popen(
            [_build.nvcc()] + _build.NVCC_FLAGS + ["-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, log))
        out[name] = (lib, log)
    return out


@contextlib.contextmanager
def loaded(path):
    """The wrapper launches the library at ``path`` inside the block."""
    _build._libs[fa._NAME] = ctypes.CDLL(path)
    _build._fns.pop(SYMBOL, None)
    try:
        yield
    finally:
        _build._libs.pop(fa._NAME, None)
        _build._fns.pop(SYMBOL, None)


def device_ms(fn, reps=20, warmup=3):
    """Device time (ms) of one ``fn()`` call: the summed time of the
    kernels it launches, from a profiler trace of ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in p.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    if not total > 0:
        raise RuntimeError("the profiler saw no device time")
    return total / reps / 1e3


def sdpa(q, k, v):
    """One ``scaled_dot_product_attention`` call over the same inputs (GQA
    native from torch 2.5, else the kv heads repeated up front)."""
    F = torch.nn.functional
    major, minor = (int(x) for x in torch.__version__.split(".")[:2])
    if (major, minor) >= (2, 5):
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
    g = q.shape[1] // k.shape[1]
    kr, vr = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    return lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_ablate: needs a CUDA device")
    libs = build(list(VARIANTS))
    for name, (_lib, log) in libs.items():
        spilled = sum(int(n) for n in re.findall(r"(\d+) bytes spill", log))
        print(json.dumps({"variant": name, "spill_bytes": spilled}))
    rng = np.random.RandomState(0)
    for where, (b, h, hkv, t, d) in SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.from_numpy(rng.randn(b, t, n, d).astype(
                np.float32)).to("cuda", dtype).transpose(1, 2)
                for n in (h, hkv, hkv))
            row = {"shape": where, "dims": [b, h, hkv, t, t, d],
                   "dtype": str(dtype).replace("torch.", ""),
                   "sdpa_device_ms": device_ms(sdpa(q, k, v))}
            for name, (vdtype, _edits) in VARIANTS.items():
                if vdtype != row["dtype"]:
                    continue
                with loaded(libs[name][0]):
                    row[name + "_device_ms"] = device_ms(
                        lambda: fa.flash_attention(q, k, v, causal=True))
            print(json.dumps(row), flush=True)
            del q, k, v
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
