"""How far int8 KV moves the served LM's logits from f32, on the CPU.

    python3 -m mxnet_tpu_torch.tools.kv_int8_spread    # from the repo root

At full width (``tools/lm.py`` ``LM``, ``SERVE_PAGED``) run it on the card
machine's CPU, not on a small host. It runs ``chip_smoke.py``'s
teacher-forced prompts (``SERVE_PAGED["forced"]``: the first sharer of the
system prompt, cold, and a joiner that forks its boundary block) through
the unpaged and the paged programs on the CPU, f32 and int8 KV, every arm
fed the f32 unpaged greedy tokens, and prints one JSON line: each int8
arm's largest |logit - f32 logit| over the steps and prompts, whether its
argmax stayed in the f32 top 5, and ``spread``, the larger of the two.
``chip_smoke.py`` holds the card's int8 arms to 1.5 x ``spread``
(``INT8_KV_TOL``): quantization moves the logits by ``spread`` on any
device, f32 rounding on the card by far less.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def spread(cfg=None, paged=None, seed=None, device="cpu"):
    """{"unpaged": {...}, "paged": {...}, "spread": x} for ``cfg`` served
    at ``paged`` (defaults: ``tools/lm.py``'s LM, SERVE_PAGED, SEED)."""
    from ..serving import generate as gen
    from . import lm

    cfg = lm.LM if cfg is None else cfg
    paged = lm.SERVE_PAGED if paged is None else paged
    seed = lm.SEED if seed is None else seed
    spec = gen.DecodeSpec(num_heads=cfg["heads"],
                          num_kv_heads=cfg["kv_heads"])
    model = gen.DecodeModel.from_arg_params(lm.lm_arg_params(cfg, seed),
                                            spec, device=device)
    prompts = lm.paged_prompts(cfg, paged, seed)
    f32 = lm.forced_arms(gen, model, paged, prompts)
    forced = [toks for _, toks in f32["unpaged"]]
    i8 = lm.forced_arms(gen, model, paged, prompts, kv_dtype="int8",
                        forced=forced)
    out = {}
    for arm in ("unpaged", "paged"):
        pairs = [(a[0], b[0]) if arm == "unpaged" else (a, b)
                 for a, b in zip(i8[arm], f32[arm])]
        top5 = all(
            got.argmax(-1)[i] in np.argsort(-ref[i])[:5]
            for got, ref in pairs for i in range(len(ref)))
        out[arm] = {"max_abs": max(float(np.abs(got - ref).max())
                                   for got, ref in pairs),
                    "argmax_in_f32_top5": bool(top5)}
    out["spread"] = max(out["unpaged"]["max_abs"], out["paged"]["max_abs"])
    return out


def main() -> int:
    import torch

    from . import lm

    t0 = time.time()
    res = spread()
    res.update(device="cpu", torch=torch.__version__,
               threads=torch.get_num_threads(),
               prompts=[len(p) for p in lm.paged_prompts(
                   lm.LM, lm.SERVE_PAGED, lm.SEED)[:2]],
               seconds=time.time() - t0)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
