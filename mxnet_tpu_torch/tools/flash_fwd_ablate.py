"""Time the flash forward with parts of its work taken out, on the card.

    python3 -m mxnet_tpu_torch.tools.flash_fwd_ablate    # from the repo root

Each variant is ``ops/kernels/csrc/flash_attention_fwd.cu`` with a few text
edits (:data:`VARIANTS`): the bf16 kernel without its second P V product
(``lo``), without the online softmax, or without both; the f32 kernel
without its S = Q K^T loop or its P V loop. A variant's O is wrong: it only
shows what the part it drops costs. The variants are built, loaded and
timed as :mod:`._variants` says, beside
``scaled_dot_product_attention``'s device time, at
the serve shape (1, 16, 4, 2048, 2048, 128) and the train shape (4, ...),
causal, in the (B, T, H, D)-storage views both paths pass. Prints one JSON
line per (type, shape): each variant's device ms and SDPA's.
"""
from __future__ import annotations

import json
import re

import numpy as np
import torch

from ..ops.kernels import flash_attention as fa
from . import _variants

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
    return _variants.edited(fa._NAME, name, VARIANTS[name][1])


def device_ms(fn):
    """Device time (ms) of one ``fn()`` call: the summed time of the
    kernels it launches."""
    return _variants.device_ms_by(fn)[0]


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
    libs = _variants.build(fa._NAME,
                           {n: variant_source(n) for n in VARIANTS})
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
                with _variants.loaded(fa._NAME, libs[name][0]):
                    row[name + "_device_ms"] = device_ms(
                        lambda: fa.flash_attention(q, k, v, causal=True))
            print(json.dumps(row), flush=True)
            del q, k, v
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
