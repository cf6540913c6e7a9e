"""Time conv_wgrad's design choices against their alternatives, on the card.

    python3 -m mxnet_tpu_torch.tools.wgrad_variants    # from the repo root

Each variant is the port's ``conv_wgrad`` with one choice undone
(:data:`VARIANTS`): the wgmma kernel's 4-stage ring of the first design
(one block an SM at 128 columns, where the 3-stage ring fits two), the
repack kernel moving one element at a time instead of pairs, the repack
as PyTorch's strided copy instead of the repack kernel, and the
f32 one-tap body held to one block an SM. The variants are built, loaded
and timed as :mod:`._variants` says; the split plan takes the variant's
blocks an SM. At ResNet-50's
seven 3x3 shapes at batch 32 (NCHW views, as the Convolution op passes
them), each variant's profiler device time of one call, split into the
partial, reduce and repack kernels, beside cuDNN's wgrad
(``torch.nn.grad.conv2d_weight``, no TF32). Prints one JSON line per
(type, shape) and one with each variant's sums over a step.
"""
from __future__ import annotations

import contextlib
import json

import torch

from ..ops.kernels import conv_wgrad as cw
from . import _variants
from ._variants import device_ms_by

#: (input H, C = K, stride) of ResNet-50's 3x3 convolutions -> how many a
#: step runs (chip_smoke.py's RESNET_WGRAD)
RESNET_WGRAD = {(56, 64, 1): 3, (56, 128, 2): 1, (28, 128, 1): 3,
                (28, 256, 2): 1, (14, 256, 1): 5, (14, 512, 2): 1,
                (7, 512, 1): 2}
BATCH = 32


def _torch_repack(t):
    """The first design's repack: PyTorch's strided copy."""
    if t.dtype == torch.bfloat16 and t.is_contiguous() and \
            t.data_ptr() % 16 == 0:
        return t
    return torch.empty(t.shape, dtype=torch.bfloat16,
                       device=t.device).copy_(t)


#: variant -> (the type it changes, [(text, replacement)] of the source,
#: {(kernel, bn): blocks an SM} for the plan, a repack to use or None);
#: each text occurs exactly once in the source
VARIANTS = {
    "bf16_this": ("bfloat16", [], {}, None),
    "bf16_ring4": ("bfloat16",
                   [("constexpr int STAGES = 3;             // two blocks",
                     "constexpr int STAGES = 4;             // two blocks")],
                   {(cw.WGMMA, 128): 1, (cw.WGMMA, 64): 2}, None),
    "bf16_repack_singles": ("bfloat16",
                            [("const bool pairs = sw == 1",
                              "const bool pairs = false && sw == 1")],
                            {}, None),
    "bf16_torch_repack": ("bfloat16", [], {}, _torch_repack),
    "f32_this": ("float32", [], {}, None),
    "f32_one_block": ("float32",
                      [("static constexpr int MIN_BLOCKS = BN == 64 ? "
                        "(TAP ? 3 : 2) : (TAP ? 2 : 1);",
                        "static constexpr int MIN_BLOCKS = BN == 64 ? "
                        "(TAP ? 3 : 2) : 1;")],
                      {(cw.F32_TAP, 128): 1}, None),
}


def variant_source(name: str) -> str:
    """conv_wgrad's source with variant ``name``'s edits; raises if an
    edit's text does not occur exactly once (the source moved on)."""
    return _variants.edited(cw._NAME, name, VARIANTS[name][1])


def build(names):
    """Build the variants ``names``; returns name -> library path."""
    libs = _variants.build(cw._NAME, {n: variant_source(n) for n in names})
    return {n: lib for n, (lib, _log) in libs.items()}


@contextlib.contextmanager
def loaded(name, path):
    """The wrappers launch variant ``name`` (its library at ``path``, its
    plan and repack) inside the block."""
    _, _edits, resident, repack = VARIANTS[name]
    saved = dict(cw.RESIDENT), cw.repack
    cw.plan.cache_clear()
    cw.RESIDENT.update(resident)
    if repack is not None:
        cw.repack = repack
    try:
        with _variants.loaded(cw._NAME, path):
            yield
    finally:
        cw.RESIDENT.clear()
        cw.RESIDENT.update(saved[0])
        cw.repack = saved[1]
        cw.plan.cache_clear()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("wgrad_variants: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    libs = build(list(VARIANTS))
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        fn = cw.wgrad if dtype == torch.float32 else cw.conv_wgrad
        for (h, c, s), per in RESNET_WGRAD.items():
            oh = cw.out_size(h, 3, s, 1)
            x = torch.randn(BATCH, c, h, h, generator=gen,
                            device="cuda").to(dtype)
            dy = torch.randn(BATCH, c, oh, oh, generator=gen,
                             device="cuda").to(dtype)
            xv, dv = x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1)
            want = cw.conv_wgrad_plain(xv, dv, 3, s, 1)
            row = {"dtype": dname, "shape": [BATCH, h, c, c, 3, s],
                   "per_step": per}
            cudnn, _ = device_ms_by(lambda: torch.nn.grad.conv2d_weight(
                x, (c, c, 3, 3), dy, stride=s, padding=1), ())
            row["cudnn_device_ms"] = cudnn
            for name, (vdtype, _e, _r, _p) in VARIANTS.items():
                if vdtype != dname:
                    continue
                with loaded(name, libs[name]):
                    got = fn(xv, dv, 3, s, 1)
                    err = float((got - want).abs().max() / want.abs().max())
                    total, split = device_ms_by(
                        lambda: fn(xv, dv, 3, s, 1),
                        ("conv_wgrad_wgmma", "conv_wgrad_f32",
                         "conv_wgrad_reduce", "conv_wgrad_repack"))
                row[name] = {"device_ms": total, "err_of_max": err,
                             "by_kernel": {k: v for k, v in split.items()
                                           if v > 0}}
                step[name] = step.get(name, 0.0) + per * total
            step["cudnn_" + dname] = step.get("cudnn_" + dname, 0.0) + \
                per * cudnn
            print(json.dumps(row), flush=True)
            del x, dy, xv, dv, want
    print(json.dumps({"step_device_ms": step}), flush=True)


if __name__ == "__main__":
    main()
