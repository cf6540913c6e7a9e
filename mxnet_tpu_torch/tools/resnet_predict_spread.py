"""How far f32 rounding alone, and int8 weights, move ResNet-50's
predictions, on the CPU.

    python3 -m mxnet_tpu_torch.tools.resnet_predict_spread [cpu|cuda]

The yardsticks of ``chip_smoke.py``'s ``serve_fixed`` ResNet gates: every
request of its traffic (``tools/serve_fixed.py``: the seeded sizes and
images) through a ``Predictor`` bound at the request's own batch on the
given device (default the CPU; ``cuda``: the card's own f32 algorithms),
from ``tools/resnet.py``'s seeded weights, three ways: in f32, in f64
(the same f32 weights widened), and with int8 weights
(``QuantizedPredictor``). Prints one JSON line: the largest |f32 - f64|
over every output (softmax probabilities), the largest |int8 - f32|, and
the smallest top-2 margin of the f32 outputs. Any two f32 orders of
summation (a batched and a single-request forward on the card, the card
and the CPU) lie about the f32-to-f64 distance apart; the card's int8
about the int8-to-f32 one from its f32. Full width takes minutes: run it
where there are cores (the card machine), not on a small host.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .resnet import RESNET, resnet_params, resnet_symbol
from .serve_fixed import SEED, SERVE_FIXED, request_images, request_sizes


def spread(cfg=RESNET, fixed=SERVE_FIXED, seed=SEED, device="cpu"):
    """{"f32_vs_f64", "int8_vs_f32", "min_margin", "requests"} on
    ``device``."""
    from .. import predict, quant

    sym = resnet_symbol(cfg).tojson()
    params = resnet_params(cfg, seed)
    wide = {k: torch.from_numpy(v).double() for k, v in params.items()}
    sizes = request_sizes(fixed, seed)
    images = request_images(cfg, sizes, seed)
    out = {"f32_vs_f64": 0.0, "int8_vs_f32": 0.0, "min_margin": np.inf,
           "requests": len(sizes)}
    binds = {}
    for x in images:
        r = x.shape[0]
        if r not in binds:
            shapes = {"data": x.shape}
            p32 = predict.Predictor(sym, params, shapes, device=device)
            binds[r] = (p32, predict.Predictor(sym, wide, shapes,
                                               dtype="float64",
                                               device=device),
                        quant.quantize_predictor(p32, quant.QuantConfig(
                            weight_dtype="int8")))
        p32, p64, p8 = binds[r]
        y32 = p32.forward(data=x)[0].asnumpy().astype(np.float64)
        y64 = p64.forward(data=x)[0].asnumpy()
        y8 = p8.forward(data=x)[0].asnumpy().astype(np.float64)
        top = np.sort(y32, axis=-1)
        out["f32_vs_f64"] = max(out["f32_vs_f64"],
                                float(np.abs(y32 - y64).max()))
        out["int8_vs_f32"] = max(out["int8_vs_f32"],
                                 float(np.abs(y8 - y32).max()))
        out["min_margin"] = min(out["min_margin"],
                                float((top[:, -1] - top[:, -2]).min()))
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    device = argv[0] if argv else "cpu"
    if device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    res = spread(device=device)
    print(json.dumps(dict(res, device=device, image=list(RESNET["image"]),
                          classes=RESNET["classes"],
                          traffic={k: SERVE_FIXED[k] for k in
                                   ("requests", "rows")})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
