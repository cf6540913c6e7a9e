"""How far rounding P and dS to bf16 moves the bf16 flash backward, on the CPU.

    python3 -m mxnet_tpu_torch.tools.flash_bwd_spread   # from the repo root

The bf16 backward kernels (``ops/kernels/csrc/flash_attention_bwd.cu``)
rebuild P = exp(scale * q.k - lse) and dS = P * (dO.v - D) in f32 and
multiply them into dO, Q and K on the tensor cores, which take bf16
operands. The TPU kernel and the plain version keep P and dS in f32. This
script repeats the kernels' arithmetic in PyTorch on the CPU: the dQ
kernel's 64-key tiles and the dK/dV kernel's 64-query tiles over each
query head of a GQA group, P in the exp2 domain from the f32 logsumexp,
f32 sums, each gradient cast to bf16 once. P (into dV) and dS (into dQ and
dK) enter their products rounded to one bf16 value or split into
hi = bf16(x) and lo = bf16(x - hi) (the kernels' choice). For each of
``chip_smoke.py``'s bf16 shapes it prints, per gradient, the largest error
against :func:`~mxnet_tpu_torch.ops.kernels.flash_attention.
flash_attention_bwd_plain` over that script's bf16 backward gate
(``BWD_TOL``): a ratio above 1 fails the gate. Inputs are seeded numpy
normals; each batch element runs on its own, to keep the memory small.
"""
from __future__ import annotations

import json
import math

import numpy as np
import torch

from ..ops.kernels.flash_attention import flash_attention_bwd_plain, \
    flash_attention_plain

#: chip_smoke.py's bf16 backward gate (atol, rtol) per gradient
GATE = {"dq": (2e-3, 2e-2), "dk": (5e-3, 2e-2), "dv": (5e-3, 2e-2)}
#: queries (dK/dV kernel) or keys (dQ kernel) per tile of the bf16 kernels
BLOCK = 64
#: which operands enter their products split into hi + lo
MODES = {"single": (False, False), "split_p": (True, False),
         "split_ds": (False, True), "split": (True, True)}
#: (b, h, hkv, tq, tk, d, causal): chip_smoke.py's flash_cases() bf16
#: shapes (layouts aside)
SHAPES = ((1, 16, 4, 128, 128, 128, True), (1, 16, 4, 512, 512, 128, True),
          (1, 16, 4, 1000, 1000, 128, True),
          (1, 16, 4, 2048, 2048, 128, True),
          (4, 16, 4, 2048, 2048, 128, True),
          (1, 16, 16, 512, 512, 128, False), (1, 16, 4, 300, 1000, 128, True),
          (2, 8, 2, 777, 777, 64, True), (1, 16, 4, 1, 1, 128, True),
          (1, 16, 4, 63, 63, 128, True), (1, 16, 4, 65, 65, 128, True),
          (1, 16, 4, 129, 129, 128, True), (1, 16, 4, 2047, 2047, 128, True),
          (2, 16, 4, 129, 515, 128, True), (1, 16, 4, 1000, 1000, 64, True),
          (4, 16, 4, 256, 256, 128, True), (1, 16, 4, 300, 300, 128, True))


def bf16_operand(x, split):
    """``x`` (f32) as the tensor cores take it: bf16(x), or hi + lo with
    hi = bf16(x) and lo = bf16(x - hi) (about 2^-16 of x), widened back
    to f32."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if split else hi


def kernel_arithmetic(q, k, v, o, lse, do, causal, split_p, split_ds,
                      scale=None, block=BLOCK):
    """(dq, dk, dv) in bf16 as the bf16 kernels compute them (see the
    module docstring); dk/dv at the (B, Hkv, Tk, D) width."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    g = h // hkv
    if scale is None:
        scale = 1.0 / d ** 0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    kr, vr = kf.repeat_interleave(g, 1), vf.repeat_interleave(g, 1)
    lse2 = lse.float()[..., None] * math.log2(math.e)           # (b, h, tq, 1)
    dvec = (dof * o.float()).sum(-1, keepdim=True)               # (b, h, tq, 1)
    c = scale * math.log2(math.e)
    qpos = torch.arange(tq)[:, None] + (tk - tq)

    def p_ds(qs, ks):
        """P and dS of queries ``qs`` against keys ``ks`` (slices)."""
        s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, qs], kr[:, :, ks])
        p = torch.exp2(s * c - lse2[:, :, qs])
        if causal:
            keep = torch.arange(tk)[None, ks] <= qpos[qs]
            p = torch.where(keep, p, torch.zeros(()))
        dp = torch.einsum("bhqd,bhkd->bhqk", dof[:, :, qs], vr[:, :, ks])
        return p, p * (dp - dvec[:, :, qs])

    dq = torch.zeros(b, h, tq, d)
    for k0 in range(0, tk, block):                    # the dQ kernel
        ks = slice(k0, k0 + block)
        _, ds = p_ds(slice(None), ks)
        dq += torch.einsum("bhqk,bhkd->bhqd", bf16_operand(ds, split_ds),
                           kr[:, :, ks])
    dk = torch.zeros(b, h, tk, d)
    dv = torch.zeros(b, h, tk, d)
    for q0 in range(0, tq, block):                    # the dK/dV kernel
        qs = slice(q0, q0 + block)
        p, ds = p_ds(qs, slice(None))
        dv += torch.einsum("bhqk,bhqd->bhkd", bf16_operand(p, split_p),
                           dof[:, :, qs])
        dk += torch.einsum("bhqk,bhqd->bhkd", bf16_operand(ds, split_ds),
                           qf[:, :, qs])
    # the dK/dV kernel sums each GQA group's heads in f32 before its store
    dk = dk.reshape(b, hkv, g, tk, d).sum(2)
    dv = dv.reshape(b, hkv, g, tk, d).sum(2)
    return ((dq * scale).bfloat16(), (dk * scale).bfloat16(), dv.bfloat16())


def gate_ratios(got, want, gate=GATE):
    """{gradient: largest |got - want| over atol + rtol |want|}."""
    out = {}
    for name, g_, w in zip(("dq", "dk", "dv"), got, want):
        atol, rtol = gate[name]
        err = (g_.float() - w.float()).abs()
        out[name] = float((err / (atol + rtol * w.float().abs())).max())
    return out


def inputs(rng, b, h, hkv, tq, tk, d, causal):
    """Seeded bf16 q/k/v/dO and the plain forward's o (bf16) and lse."""
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, n, t, d), dtype=np.float32)).bfloat16()
        for n, t in ((h, tq), (hkv, tk), (hkv, tk), (h, tq)))
    o, lse = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    return q, k, v, o, lse, do


def shape_ratios(shape, rng, modes=MODES):
    """{mode: {gradient: worst ratio over the batch}} at ``shape``."""
    b, h, hkv, tq, tk, d, causal = shape
    worst = {m: dict.fromkeys(("dq", "dk", "dv"), 0.0) for m in modes}
    for _ in range(b):
        args = inputs(rng, 1, h, hkv, tq, tk, d, causal)
        want = flash_attention_bwd_plain(*args, causal=causal)
        for mode, (sp, sd) in modes.items():
            got = kernel_arithmetic(*args, causal, sp, sd)
            for name, r in gate_ratios(got, want).items():
                worst[mode][name] = max(worst[mode][name], r)
    return worst


def main(shapes=SHAPES, seed=0):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    rng = np.random.default_rng(seed)
    for shape in shapes:
        print(json.dumps({"shape": list(shape[:6]), "causal": shape[6],
                          "gate": GATE, "ratio": shape_ratios(shape, rng)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
