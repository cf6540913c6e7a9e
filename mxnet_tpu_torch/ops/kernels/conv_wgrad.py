"""Convolution weight gradient: the CUDA kernels' wrappers, their plan and
their plain version.

Replaces ``mxnet_tpu/ops/pallas/conv_bwd.py``'s ``conv_wgrad`` (the Pallas
kernel ``_wgrad_kernel``); the kernels are ``csrc/conv_wgrad.cu``, whose
header says what bounds them and what their design does about that.

:func:`conv_wgrad` keeps the reference's signature and result: x NHWC
(N, H, W, C), dy NHWC (N, OH, OW, K), a square ``ksz`` window, one
``stride`` and one symmetric ``pad`` (default ``(ksz - 1) // 2``) on both
spatial axes; it returns dW as f32 HWIO (ksz, ksz, C, K), with x and dy cast
to bf16 first as the reference casts them. :func:`wgrad` is the same
function without the cast, for the f32 path of the ``Convolution`` op.

Both take any strides, so NCHW tensors pass as ``permute(0, 2, 3, 1)``
views. For CPU tensors the plain version runs; for CUDA tensors :func:`plan`
picks one of three partial-sum kernels (its ``route``) and the split of the
reduction, and the fixed-order reduction kernel follows. Each wrapper counts
its launches in ``conv_wgrad_partial.launches`` /
``conv_wgrad_reduce.launches``, or the call raises — it never falls back.
Unlike the reference there is no selection table (``use_wgrad_for``): a
CUDA tensor always takes a kernel.

- ``"f32"``: f32 x and dy, read through their strides by ``cp.async``.
- ``"wgmma"``: bf16 with C and K multiples of 8 and a stride of 1 or 2
  dividing H and W. The tensor cores read x and dy by TMA, which wants
  every stride a multiple of 16 bytes: :func:`repack` (a hand-written
  transpose kernel, counted in ``repack.launches``) copies each
  into contiguous NHWC bf16 first, inside the call, the cast fused in.
- ``"simt"``: any other bf16 case, read through its strides.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from ._launches import counted, launched

_NAME = "conv_wgrad"
_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the f32 kernel's block rows and rows of L a stage (csrc/conv_wgrad.cu
# rt::BM, rt::BL)
TILE_M, TILE_L = 128, 16
# the wgmma kernel: rows of L a tile (one TMA box), rows of M a warpgroup,
# warpgroups a block (wg::BL, 64, 2)
WG_ROWS, WG_M, WG_GROUPS = 64, 64, 2
# the simt kernel's tile and rows of L a step (simt::BM = BN, simt::BL)
SIMT_TILE, SIMT_L = 64, 32
# the columns of K a block of the f32 and wgmma kernels takes (their
# template instantiations)
BLOCK_COLS = (64, 128)
SMS = 132
# the partial kernels (csrc/conv_wgrad.cu), by route; the f32 route's
# one-tap body takes C a multiple of TILE_M
F32, F32_TAP = "conv_wgrad_f32_kernel", "conv_wgrad_f32tap_kernel"
WGMMA, SIMT = "conv_wgrad_wgmma_kernel", "conv_wgrad_simt_kernel"
# blocks of a (kernel, bn) one SM holds at once: the f32 kernels'
# registers (ptxas), the wgmma kernel's shared memory (3 stages of 24 or
# 32 KB), the simt kernel's 256 threads at 127 registers
RESIDENT = {(F32, 64): 2, (F32, 128): 1, (F32_TAP, 64): 3,
            (F32_TAP, 128): 2, (WGMMA, 64): 3, (WGMMA, 128): 2,
            (SIMT, 64): 2}
# rows of L a split sums at least
MIN_SPLIT_ROWS = 256
# flop/s a route's partial kernel is planned at (not measured: the split
# plan weighs the reduction's bytes against the products with them)
RATE = {"f32": 40e12, "wgmma": 400e12, "simt": 20e12}

Plan = collections.namedtuple(
    "Plan", "route kernel bn box tiles units step splits chunk")
Plan.__doc__ = """How a CUDA call runs. ``route`` "f32" / "wgmma" /
"simt"; ``kernel`` the partial kernel's name; ``bn`` columns of K a block;
``box`` (bw, bh, bi), the TMA box of
an L tile along OW, OH and N (wgmma; else None); ``tiles`` output blocks;
``units`` the reduction in the split's units (rows of L, or L tiles for
wgmma), cut into ``splits`` of ``chunk`` units, a multiple of ``step``."""


def _cdiv(a, b):
    return -(-a // b)


def _pow2(v):
    return 1 << max(0, v - 1).bit_length()


def out_size(size, ksz, stride, pad):
    """Output extent of a (ksz, stride, pad) window over ``size``."""
    return (size + 2 * pad - ksz) // stride + 1


def _check(x, dy, ksz, stride, pad, types=True):
    """Shape (and, with ``types``, type) checks shared by both paths."""
    if x.dim() != 4 or dy.dim() != 4:
        raise ValueError("conv_wgrad wants 4-D x (N, H, W, C) and dy "
                         "(N, OH, OW, K)")
    n, h, w, _c = x.shape
    if ksz < 1 or stride < 1 or pad < 0:
        raise ValueError("conv_wgrad: ksz %d, stride %d, pad %d"
                         % (ksz, stride, pad))
    want = (n, out_size(h, ksz, stride, pad), out_size(w, ksz, stride, pad))
    if tuple(dy.shape[:3]) != want:
        raise ValueError("conv_wgrad: dy %s does not match x %s for ksz %d, "
                         "stride %d, pad %d (want (N, OH, OW) = %s)"
                         % (tuple(dy.shape), tuple(x.shape), ksz, stride,
                            pad, want))
    if types and x.dtype != dy.dtype:
        raise TypeError("conv_wgrad: x %s and dy %s differ in type"
                        % (x.dtype, dy.dtype))
    if x.device != dy.device:
        raise ValueError("conv_wgrad: x and dy on different devices")


def conv_wgrad_plain(x, dy, ksz, stride=1, pad=None):
    """Plain PyTorch version of the reference's Pallas kernel, in f32: pad
    x, take the ksz * ksz shifted, strided views, and one einsum each over
    (N, OH, OW). Returns f32 HWIO (ksz, ksz, C, K)."""
    if pad is None:
        pad = (ksz - 1) // 2
    n, h, w, c = x.shape
    _, oh, ow, k = dy.shape
    hp, wp = oh * stride + ksz - 1, ow * stride + ksz - 1
    xp = F.pad(x.float(), (0, 0, pad, wp - w - pad, pad, hp - h - pad))
    dyf = dy.float()
    out = torch.empty((ksz, ksz, c, k), dtype=torch.float32, device=x.device)
    for kh in range(ksz):
        for kw in range(ksz):
            xs = xp[:, kh:kh + oh * stride:stride, kw:kw + ow * stride:stride]
            out[kh, kw] = torch.einsum("nhwc,nhwk->ck", xs, dyf)
    return out


def pick_splits(tiles, slots, units, step, min_units, reduce_cost=0.0):
    """(splits, chunk) of ``units`` of reduction over ``tiles`` output
    blocks on ``slots`` resident blocks: ``chunk`` a multiple of ``step``
    and at least ``min_units`` (unless the whole is less), no split empty.
    The blocks run in rounds of ``slots``, each block 1/splits of the
    work, and the reduction reads every split's slice again, each
    ``reduce_cost`` of the work: the time goes as
    ceil(tiles * splits / slots) / splits + reduce_cost * splits, from at
    least one round's worth of blocks (a block alone on an SM leaves it
    idle in part). Returns the fewest splits within 5% of the best."""
    top = max(1, min(units // max(min_units, 1),
                     4 * _cdiv(slots, tiles) + 1, 65535))
    cands = []
    for want in range(min(top, max(1, slots // tiles)), top + 1):
        chunk = _cdiv(_cdiv(units, want), step) * step
        s = _cdiv(units, chunk)
        cands.append((_cdiv(tiles * s, slots) / s + reduce_cost * s, s,
                      chunk))
    best = min(c[0] for c in cands)
    return min((s, chunk) for cost, s, chunk in cands if cost <= 1.05 * best)


def reduce_cost(l, rate):
    """A split slice's share of a call's time: 4 bytes of dW written and
    read again against 2 * L flops at ``rate`` flop/s, at 3 TB/s."""
    return 2 * 4 / 3e12 / (2 * l / rate)


def splits_for(m, k, l, kernel=F32):
    """(splits, chunk) of the f32 route's reduction L over its
    (M / 128) x (K / bn) output blocks of ``kernel``; ``chunk`` (rows per
    split) a multiple of the kernel's 16-row stage."""
    bn = 64 if k <= 64 else 128
    tiles = _cdiv(m, TILE_M) * _cdiv(k, bn)
    return pick_splits(tiles, RESIDENT[(kernel, bn)] * SMS, l, TILE_L,
                       MIN_SPLIT_ROWS, reduce_cost(l, RATE["f32"]))


def wgmma_box(oh, ow):
    """(bw, bh, bi): the TMA box of one 64-row L tile along OW, OH and N,
    powers of two, W first, covering OW and OH where they fit (8 / 16 / 32
    / 64 at OW = 7 / 14 / 28 / 56)."""
    bw = min(WG_ROWS, _pow2(ow))
    bh = min(WG_ROWS // bw, _pow2(oh))
    return bw, bh, WG_ROWS // (bw * bh)


def takes_wgmma(c, k, h, w, stride):
    """Whether bf16 x (.., H, W, C) and dy (.., K) take the TMA route: C
    and K rows a multiple of 16 bytes, and H and W whole multiples of the
    stride (x's parity planes then tile it exactly)."""
    return c % 8 == 0 and k % 8 == 0 and stride <= 2 and h % stride == 0 \
        and w % stride == 0


@functools.lru_cache(maxsize=256)
def plan(n, h, w, c, k, ksz, stride, pad, dtype):
    """The :class:`Plan` of one CUDA call on x (n, h, w, c) and dy
    (n, oh, ow, k) of ``dtype`` ("float32" or "bfloat16")."""
    oh, ow = out_size(h, ksz, stride, pad), out_size(w, ksz, stride, pad)
    l, m = n * oh * ow, ksz * ksz * c
    if dtype == "float32":
        bn = 64 if k <= 64 else 128
        kernel = F32_TAP if c % TILE_M == 0 else F32
        tiles = _cdiv(m, TILE_M) * _cdiv(k, bn)
        splits, chunk = splits_for(m, k, l, kernel)
        return Plan("f32", kernel, bn, None, tiles, l, TILE_L, splits,
                    chunk)
    if dtype != "bfloat16":
        raise TypeError("conv_wgrad kernel takes float32 or bfloat16, not %s"
                        % dtype)
    if takes_wgmma(c, k, h, w, stride):
        bn = 64 if k <= 64 else 128
        bw, bh, bi = wgmma_box(oh, ow)
        units = _cdiv(n, bi) * _cdiv(oh, bh) * _cdiv(ow, bw)
        tiles = _cdiv(ksz * ksz * _cdiv(c, WG_M), WG_GROUPS) * _cdiv(k, bn)
        splits, chunk = pick_splits(tiles, RESIDENT[(WGMMA, bn)] * SMS,
                                    units, 1, MIN_SPLIT_ROWS // WG_ROWS,
                                    reduce_cost(l, RATE["wgmma"]))
        return Plan("wgmma", WGMMA, bn, (bw, bh, bi), tiles, units, 1,
                    splits, chunk)
    tiles = _cdiv(m, SIMT_TILE) * _cdiv(k, SIMT_TILE)
    splits, chunk = pick_splits(tiles, RESIDENT[(SIMT, 64)] * SMS, l,
                                SIMT_L, MIN_SPLIT_ROWS,
                                reduce_cost(l, RATE["simt"]))
    return Plan("simt", SIMT, SIMT_TILE, None, tiles, l, SIMT_L, splits,
                chunk)


def plan_of(x, dy, ksz, stride, pad):
    """:func:`plan` of tensors x (N, H, W, C) and dy (N, OH, OW, K)."""
    n, h, w, c = x.shape
    return plan(n, h, w, c, dy.shape[3], ksz, stride, pad,
                str(x.dtype).replace("torch.", ""))


def repack(t):
    """``t`` (N, H, W, C), f32 or bf16 through any strides, as contiguous
    NHWC bf16 on a 16-byte boundary (the wgmma route's operand form), the
    cast fused into the one copy; ``t`` itself when it already is. CUDA
    tensors launch the repack kernel (counted in ``repack.launches``); CPU
    tensors take a PyTorch copy."""
    if t.dtype == torch.bfloat16 and t.is_contiguous() and \
            t.data_ptr() % 16 == 0:
        return t
    out = torch.empty(t.shape, dtype=torch.bfloat16, device=t.device)
    if t.device.type == "cpu":
        return out.copy_(t)
    if t.dtype not in _REPACK_CODE:
        raise TypeError("conv_wgrad repack takes float32 or bfloat16, not %s"
                        % t.dtype)
    n, h, w, c = t.shape
    with torch.cuda.device(t.device):
        err = _lib("mxtt_conv_wgrad_repack", [_PTR, _PTR] + [_I32] * 5
                   + [_I64] * 4 + [_PTR])(
            t.data_ptr(), out.data_ptr(), _REPACK_CODE[t.dtype], n, h, w, c,
            *t.stride(), _stream(t))
    if err != 0:
        raise RuntimeError("conv_wgrad repack launch failed: cudaError %d"
                           % err)
    repack.launches += 1
    return out


counted(repack)
_REPACK_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib(symbol, argtypes):
    from . import _build

    return _build.kernel(_NAME, symbol, argtypes)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def conv_wgrad_partial(x, dy, ksz, stride, pad):
    """Launch the partial-sum kernel of :func:`plan`'s route on CUDA x / dy
    (checked by :func:`wgrad`; repacked first for the wgmma route); returns
    the f32 workspace (splits, M, K) and counts the launch (by type) in
    ``conv_wgrad_partial.launches``."""
    p = plan_of(x, dy, ksz, stride, pad)
    n, h, w, c = x.shape
    _, oh, ow, k = dy.shape
    ws = torch.empty((p.splits, ksz * ksz * c, k), dtype=torch.float32,
                     device=x.device)
    geo = (n, h, w, c, oh, ow, k, ksz, stride, pad)
    with torch.cuda.device(x.device):
        if p.route == "f32":
            err = _lib("mxtt_conv_wgrad_f32", [_PTR] * 3 + [_I32] * 14
                       + [_I64] * 8 + [_PTR])(
                x.data_ptr(), dy.data_ptr(), ws.data_ptr(), *geo, p.bn,
                int(p.kernel == F32_TAP), p.splits, p.chunk, *x.stride(),
                *dy.stride(), _stream(x))
        elif p.route == "wgmma":
            for t in (x, dy):
                if not t.is_contiguous() or t.data_ptr() % 16:
                    raise ValueError("conv_wgrad wgmma route: operands must "
                                     "be contiguous NHWC on 16 bytes "
                                     "(repack them)")
            err = _lib("mxtt_conv_wgrad_wgmma", [_PTR] * 3 + [_I32] * 16
                       + [_PTR])(
                x.data_ptr(), dy.data_ptr(), ws.data_ptr(), *geo, p.bn,
                *p.box, p.splits, p.chunk, _stream(x))
        else:
            err = _lib("mxtt_conv_wgrad_simt", [_PTR] * 3 + [_I32] * 12
                       + [_I64] * 8 + [_PTR])(
                x.data_ptr(), dy.data_ptr(), ws.data_ptr(), *geo, p.splits,
                p.chunk, *x.stride(), *dy.stride(), _stream(x))
    if err != 0:
        raise RuntimeError("conv_wgrad partial (%s) launch failed: "
                           "cudaError %d" % (p.route, err))
    launched(conv_wgrad_partial, x.dtype)
    return ws


def conv_wgrad_reduce(ws, ksz, c):
    """Launch the reduction kernel over the workspace of
    :func:`conv_wgrad_partial` (slices summed in order); returns dW f32
    HWIO and counts the launch in ``conv_wgrad_reduce.launches``."""
    splits, m, k = ws.shape
    out = torch.empty((ksz, ksz, c, k), dtype=torch.float32, device=ws.device)
    with torch.cuda.device(ws.device):
        err = _lib("mxtt_conv_wgrad_reduce",
                   [_PTR, _PTR, _I64, _I32, _PTR])(
            ws.data_ptr(), out.data_ptr(), m * k, splits, _stream(ws))
    if err != 0:
        raise RuntimeError("conv_wgrad reduce launch failed: cudaError %d"
                           % err)
    conv_wgrad_reduce.launches += 1
    return out


counted(conv_wgrad_partial)
counted(conv_wgrad_reduce)


def wgrad(x, dy, ksz, stride=1, pad=None):
    """dW f32 HWIO (ksz, ksz, C, K) of x (N, H, W, C) and dy (N, OH, OW, K)
    in their own type (f32 or bf16), without :func:`conv_wgrad`'s cast.
    CPU tensors take the plain version; CUDA tensors launch the partial
    kernel of :func:`plan`'s route (after :func:`repack` on the wgmma
    route) and the reduction kernel."""
    if pad is None:
        pad = (ksz - 1) // 2
    _check(x, dy, ksz, stride, pad)
    if x.device.type == "cpu":
        return conv_wgrad_plain(x, dy, ksz, stride, pad)
    if x.device.type != "cuda":
        raise ValueError("conv_wgrad: no path for device %s" % x.device)
    if x.numel() == 0 or dy.numel() == 0:
        raise ValueError("conv_wgrad: empty input %s / %s"
                         % (tuple(x.shape), tuple(dy.shape)))
    if plan_of(x, dy, ksz, stride, pad).route == "wgmma":
        x, dy = repack(x), repack(dy)
    ws = conv_wgrad_partial(x, dy, ksz, stride, pad)
    return conv_wgrad_reduce(ws, ksz, x.shape[3])


def conv_wgrad(x, dy, ksz, stride=1, pad=None):
    """The reference's ``conv_wgrad``: x and dy cast to bf16, then
    :func:`wgrad`. Returns f32 HWIO (ksz, ksz, C, K). On the wgmma route
    the cast is the repack's (one pass over each operand)."""
    if pad is None:
        pad = (ksz - 1) // 2
    _check(x, dy, ksz, stride, pad, types=False)
    n, h, w, c = x.shape
    if x.device.type == "cuda" and x.numel() and dy.numel() and \
            x.dtype in _REPACK_CODE and dy.dtype in _REPACK_CODE and plan(
                n, h, w, c, dy.shape[3], ksz, stride, pad,
                "bfloat16").route == "wgmma":
        x, dy = repack(x), repack(dy)
    return wgrad(x.to(torch.bfloat16), dy.to(torch.bfloat16), ksz, stride,
                 pad)
