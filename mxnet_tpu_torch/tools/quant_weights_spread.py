"""How far weight quantization moves the served LM's logits from f32, on
the CPU.

    python3 -m mxnet_tpu_torch.tools.quant_weights_spread   # from the repo root

At full width (``tools/lm.py`` ``LM``, ``SERVE_SPEC``) run it on the card
machine's CPU, not on a small host. It runs ``chip_smoke.py``'s
teacher-forced prompts (``SERVE_SPEC["forced"]``: the first sharer of the
system prompt and a joiner) through the unpaged programs on the CPU, f32
weights and each quantized arm (``ARMS``: int8 weights with int8
activations, int8 weights dequantized on load into an f32 product, and
fp8-e4m3 weights), every arm fed the f32 greedy tokens, and prints one
JSON line: each arm's largest |logit - f32 logit| over the steps and
prompts and whether its argmax stayed in the f32 top 5.
``chip_smoke.py`` holds the card's ``quant_weights`` arms to 1.5 x their
arm's distance (``QUANT_WEIGHTS_TOL``), as ``kv_int8_spread.py`` sets the
int8 KV gate.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

#: arm -> (weight dtype, activation strategy)
ARMS = {"int8": ("int8", "int8"), "int8_f32": ("int8", "float32"),
        "fp8": ("fp8_e4m3", "int8")}


def spread(cfg=None, serve=None, seed=None, device="cpu", arms=None):
    """{arm: {"max_abs": x, "argmax_in_f32_top5": bool}} for ``cfg``
    served at ``serve`` (defaults: ``tools/lm.py``'s LM, SERVE_SPEC,
    SEED)."""
    from .. import quant
    from ..serving import generate as gen
    from . import lm

    cfg = lm.LM if cfg is None else cfg
    serve = lm.SERVE_SPEC if serve is None else serve
    seed = lm.SEED if seed is None else seed
    spec = gen.DecodeSpec(num_heads=cfg["heads"],
                          num_kv_heads=cfg["kv_heads"])
    model = gen.DecodeModel.from_arg_params(lm.lm_arg_params(cfg, seed),
                                            spec, device=device)
    prompts = lm.paged_prompts(cfg, serve, seed)
    steps = serve["max_new_tokens"] - 1

    def programs(m):
        return gen.DecodePrograms(m, serve["slots"], serve["max_context"],
                                  serve["prefill_buckets"])

    ref = [lm.forced_unpaged(programs(model), prompts[i], steps)
           for i in serve["forced"]]
    out = {}
    for arm in (ARMS if arms is None else arms):
        weight, act = ARMS[arm]
        qm = quant.quantize_decode_model(
            model, quant.QuantConfig(weight_dtype=weight, act_dtype=act))
        progs = programs(qm)
        got = [lm.forced_unpaged(progs, prompts[i], steps, fed)[0]
               for i, (_, fed) in zip(serve["forced"], ref)]
        pairs = [(g, r) for g, (r, _) in zip(got, ref)]
        out[arm] = {
            "max_abs": max(float(np.abs(g - r).max()) for g, r in pairs),
            "argmax_in_f32_top5": bool(all(
                g.argmax(-1)[i] in np.argsort(-r[i])[:5]
                for g, r in pairs for i in range(len(r))))}
    return out


def main() -> int:
    import torch

    from . import lm

    t0 = time.time()
    res = spread()
    res = {"arms": res, "device": "cpu", "torch": torch.__version__,
           "threads": torch.get_num_threads(),
           "prompts": [len(p) for p in lm.paged_prompts(
               lm.LM, lm.SERVE_SPEC, lm.SEED)[:2]],
           "steps": lm.SERVE_SPEC["max_new_tokens"] - 1,
           "seconds": time.time() - t0}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
