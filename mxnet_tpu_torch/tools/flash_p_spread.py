"""How far rounding P to bf16 moves the bf16 flash forward, on the CPU.

    python3 -m mxnet_tpu_torch.tools.flash_p_spread     # from the repo root

The bf16 forward kernel (``ops/kernels/csrc/flash_attention_fwd.cu``)
computes P = exp2(S - m) in f32 and multiplies it into V on the tensor
cores, which take bf16 operands. The TPU kernel and the plain version keep
P in f32. This script repeats the kernel's arithmetic in PyTorch on the
CPU (128-key tiles, the online softmax in the exp2 domain, the row sum l
from the f32 P, O cast to bf16) with P rounded to one bf16 value
("single") or split into hi = bf16(p) and lo = bf16(p - hi) ("split", the
kernel's choice), and prints for each shape the largest error against
:func:`~mxnet_tpu_torch.ops.kernels.flash_attention.flash_attention_plain`
over ``chip_smoke.py``'s bf16 gate (atol 2e-3 + rtol 2e-2 of |O|): a
ratio above 1 fails the gate. Inputs are seeded numpy normals, as there.
"""
from __future__ import annotations

import json
import math

import numpy as np
import torch

from ..ops.kernels.flash_attention import flash_attention_plain

#: chip_smoke.py's bf16 forward gate (atol, rtol)
GATE = (2e-3, 2e-2)
#: keys per tile of the bf16 kernel
BLOCK = 128
#: (b, h, hkv, tq, tk, d, causal): chip_smoke.py's bf16 forward shapes
SHAPES = ((1, 16, 4, 128, 128, 128, True), (1, 16, 4, 512, 512, 128, True),
          (1, 16, 4, 1000, 1000, 128, True), (1, 16, 4, 2048, 2048, 128, True),
          (1, 16, 16, 512, 512, 128, False), (1, 16, 4, 300, 1000, 128, True),
          (2, 8, 2, 777, 777, 64, True), (1, 16, 4, 63, 63, 128, True))


def split_bf16(p):
    """(hi, lo): bf16 parts with hi + lo = p to about 2^-16 of p."""
    hi = p.bfloat16()
    return hi, (p - hi.float()).bfloat16()


def kernel_arithmetic(q, k, v, causal, split, block=BLOCK):
    """O (bf16) as the bf16 kernel computes it: f32 logits, 128-key tiles
    of the online softmax in the exp2 domain, P rounded to bf16 (or split
    into hi + lo) before P.V, l from the unrounded P."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    g = h // hkv
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) \
        * (d ** -0.5 * math.log2(math.e))
    if causal:
        keep = (torch.arange(tk)[None, :]
                <= torch.arange(tq)[:, None] + (tk - tq))
        s = torch.where(keep, s, torch.tensor(-math.inf))
    m = torch.full((b, h, tq, 1), -math.inf)
    l = torch.zeros(b, h, tq, 1)
    o = torch.zeros(b, h, tq, d)
    for k0 in range(0, tk, block):
        st = s[..., k0:k0 + block]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        mu = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        alpha, p = torch.exp2(m - mu), torch.exp2(st - mu)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi, lo = split_bf16(p)
        used = hi.float() + lo.float() if split else hi.float()
        o = o * alpha + torch.einsum("bhqk,bhkd->bhqd", used,
                                     vf[:, :, k0:k0 + block])
        m = m_new
    return (o / l).bfloat16()


def gate_ratio(got, want, gate=GATE):
    """Largest |got - want| over atol + rtol |want|."""
    err = (got.float() - want.float()).abs()
    return float((err / (gate[0] + gate[1] * want.float().abs())).max())


def main(shapes=SHAPES, seed=0):
    rng = np.random.default_rng(seed)
    for b, h, hkv, tq, tk, d, causal in shapes:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, n, t, d), dtype=np.float32)).bfloat16()
            for n, t in ((h, tq), (hkv, tk), (hkv, tk)))
        want = flash_attention_plain(q, k, v, causal=causal)
        print(json.dumps({
            "shape": [b, h, hkv, tq, tk, d], "causal": causal,
            "gate": GATE, "ratio_single_bf16_p": gate_ratio(
                kernel_arithmetic(q, k, v, causal, False), want),
            "ratio_split_p": gate_ratio(
                kernel_arithmetic(q, k, v, causal, True), want)}),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
