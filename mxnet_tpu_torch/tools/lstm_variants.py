"""Time lstm_step's tile and ring choices against their alternatives, on
the card.

    python3 -m mxnet_tpu_torch.tools.lstm_variants     # from the repo root

Each variant is ``csrc/lstm_step.cu`` with its constants edited
(:data:`VARIANTS`): the f32 bodies' tile (the first form's one k slice
of 4 x 4 a thread, or two slices of 8 x 1), k chunk (``BK``) and ring
depth (``STAGES``), the sigmoid's exp, and the wgmma body's ring depth
and units a block (16: m64n64, half the blocks, so half the reads of
each h tile); each ablation
(:data:`ABLATIONS`) takes one part out, to show where the time goes. The
variants are built, loaded and timed as :mod:`._variants` says. At the
scan's main-path shapes (``STEP_SHAPES``: N = 128 and 8, H = 512, in the
scan's layout: Wh a view into the parameter blob at 4H * I, h and c rows),
each variant is held against the plain version at ``STEP_TOL`` (both
chip_smoke.py's too) and timed: the profiler's device time of one step,
f32 and bf16. Prints one JSON line per variant, its registers and spills
from ptxas, and the card's name and power limit.
"""
from __future__ import annotations

import json
import math
import re

import torch

from ..ops.kernels import lstm as kl
from . import _variants
from .lm import nvidia_smi
from .lstm_lm import STEP_SHAPES, STEP_TOL

#: variant -> [(text, replacement)] of the source; each text occurs
#: exactly once in it
VARIANTS = {
    "this": [],
    "f32_first_form": [("static constexpr int TM = WIDE ? 8 : 1;",
                        "static constexpr int TM = WIDE ? 4 : 1;"),
                       ("static constexpr int TU = WIDE ? 2 : 1;",
                        "static constexpr int TU = 1;"),
                       ("static constexpr int KW = WIDE ? 4 : 1;",
                        "static constexpr int KW = 1;")],
    "f32_kw2": [("static constexpr int TU = WIDE ? 2 : 1;",
                 "static constexpr int TU = 1;"),
                ("static constexpr int KW = WIDE ? 4 : 1;",
                 "static constexpr int KW = WIDE ? 2 : 1;")],
    "f32_ring6": [("static constexpr int STAGES = WIDE ? 3 : 4;",
                   "static constexpr int STAGES = WIDE ? 6 : 8;")],
    "f32_bk64": [("static constexpr int BK = WIDE ? 32 : 64;",
                  "static constexpr int BK = WIDE ? 64 : 32;")],
    "fast_exp": [("return 1.f / (1.f + expf(-x));",
                  "return 1.f / (1.f + __expf(-x));")],
    "wgmma_ring8": [("constexpr int STAGES = 4;",
                     "constexpr int STAGES = 8;")],
    "wgmma_bj16": [("return wg::launch<8>(a, s);",
                    "return wg::launch<16>(a, s);")],
}
#: ablations: one part of a body taken out, so their results are wrong and
#: not checked: the f32 body without its k loop (the prologue's loads and
#: the epilogue alone), without its products (the cp.async ring alone),
#: and the wgmma body without its products (the TMA ring alone)
ABLATIONS = {
    "f32_no_k_loop": [("const int nk = (H + L::BK - 1) / L::BK;",
                       "const int nk = 0;")],
    "f32_no_products": [("for (int kk = 0; kk < L::KS; kk += 4) {",
                         "for (int kk = 0; kk < 0; kk += 4) {")],
    "wgmma_no_products": [("    mma_stage<BJ>(acc, st, st + A_BYTES);\n",
                           "")],
}


def variant_source(name: str) -> str:
    """lstm_step's source with variant ``name``'s edits; raises if an
    edit's text does not occur exactly once (the source moved on)."""
    return _variants.edited(kl._NAME, name, {**VARIANTS, **ABLATIONS}[name])


def build(names):
    """Build the variants ``names``; returns name -> (library path, the
    ptxas registers / spills lines)."""
    libs = _variants.build(kl._NAME, {n: variant_source(n) for n in names})
    return {n: (lib, ptxas_lines(log)) for n, (lib, log) in libs.items()}


def ptxas_lines(log):
    """{kernel: "registers, spills"} of the f32 and wgmma bodies in an
    nvcc ``-Xptxas -v`` log."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for \w*?(lstm_(?:f32|wgmma)_"
                      r"kernelILi(\d+)E)", line)
        if m:
            cur = "%s<%s>" % (m.group(1).split("I")[0], m.group(2))
            continue
        if cur and "spill" in line:
            out[cur] = line.strip()
        elif cur and "registers" in line:
            out[cur] = "%s; %s" % (out.get(cur, ""), line.split(": ")[-1])
            cur = None
    return out


def scan_inputs(n, h, dtype, gen):
    """One step's inputs in the scan's layout: ib (N, 4H), h and c rows,
    Wh a (4H, H) view into a parameter blob at 4H * I (I = H)."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    blob = (randn(8 * h * h) / math.sqrt(h)).to(dtype)
    return (randn(n, 4 * h).to(dtype), (0.5 * randn(n, h)).to(dtype),
            randn(n, h).to(dtype), blob[4 * h * h:].view(4 * h, h))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("lstm_variants: needs a CUDA device")
    libs = build(list(VARIANTS) + list(ABLATIONS))
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {(dtype, n, h): scan_inputs(n, h, getattr(torch, dtype), gen)
             for dtype in STEP_TOL for n, h in STEP_SHAPES}
    for name, (lib, ptxas) in libs.items():
        ablation = name in ABLATIONS
        row = {"variant": name, "ablation": ablation,
               "edits": {**VARIANTS, **ABLATIONS}[name], "ptxas": ptxas}
        with _variants.loaded(kl._NAME, lib):
            for (dtype, n, h), (ib, hs, cs, wh) in cases.items():
                h_out, c_out = torch.empty_like(hs), torch.empty_like(cs)
                got = kl.lstm_step(ib, hs, cs, wh, h_out, c_out)
                want = kl.lstm_step_plain(ib, hs, cs, wh)
                atol, rtol = STEP_TOL[dtype]
                for g, w in zip(got, want):
                    if not ablation:
                        torch.testing.assert_close(g.float(), w.float(),
                                                   atol=atol, rtol=rtol)
                row["%s %dx%d" % (dtype, n, h)] = {
                    "route": kl.plan_of(hs, wh).route,
                    "device_ms": _variants.device_ms_by(
                        lambda: kl.lstm_step(ib, hs, cs, wh, h_out, c_out),
                        reps=50, warmup=5)[0]}
        print(json.dumps(row), flush=True)
    print(nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
