"""Convolution weight gradient: the CUDA kernels' wrappers and their plain
version.

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
views. For CPU tensors the plain version runs; for CUDA tensors the split
partial-sum kernel and the fixed-order reduction kernel launch, each
counting its launches in ``conv_wgrad_partial.launches`` /
``conv_wgrad_reduce.launches``, or the call raises — it never falls back.
Unlike the reference there is no selection table (``use_wgrad_for``): a
CUDA tensor always takes the kernel.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_NAME = "conv_wgrad"
_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the kernel's tile (csrc/conv_wgrad.cu BM, BN, BL)
TILE_M, TILE_N, TILE_L = 64, 64, 32
# blocks a launch aims for: about four per SM of the H100's 132
TARGET_BLOCKS = 4 * 132
# rows of L a split sums at least (8 staging steps)
MIN_SPLIT_ROWS = 8 * TILE_L


def _cdiv(a, b):
    return -(-a // b)


def out_size(size, ksz, stride, pad):
    """Output extent of a (ksz, stride, pad) window over ``size``."""
    return (size + 2 * pad - ksz) // stride + 1


def _check(x, dy, ksz, stride, pad):
    """Shape/type checks shared by both paths."""
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
    if x.dtype != dy.dtype:
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


def splits_for(m, k, l):
    """(splits, chunk) of the reduction L over blocks: enough splits that
    the (M/64) x (K/64) output tiles make about ``TARGET_BLOCKS`` blocks,
    each summing at least ``MIN_SPLIT_ROWS`` rows; ``chunk`` (rows per
    split) a multiple of the kernel's 32-row step."""
    tiles = _cdiv(m, TILE_M) * _cdiv(k, TILE_N)
    s = max(1, min(_cdiv(TARGET_BLOCKS, tiles), _cdiv(l, MIN_SPLIT_ROWS),
                   65535))
    chunk = _cdiv(_cdiv(l, s), TILE_L) * TILE_L
    return _cdiv(l, chunk), chunk


def _kernel():
    from . import _build

    return _build.kernel(_NAME, "mxtt_conv_wgrad",
                         [_I32] + [_PTR] * 4 + [_I32] * 13 + [_I64] * 8
                         + [_PTR])


def _launch(which, name, x, dy, ws, out, ksz, stride, pad, splits, chunk):
    n, h, w, c = x.shape
    _, oh, ow, k = dy.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(
            which, x.data_ptr(), dy.data_ptr(), ws.data_ptr(),
            out.data_ptr(), _DTYPE_CODE[x.dtype], n, h, w, c, oh, ow, k, ksz,
            stride, pad, splits, chunk, *x.stride(), *dy.stride(), stream)
    if err != 0:
        raise RuntimeError("%s launch failed: cudaError %d" % (name, err))


def conv_wgrad_partial(x, dy, ksz, stride, pad):
    """Launch the partial-sum kernel on CUDA x / dy (checked by
    :func:`wgrad`); returns the f32 workspace (splits, M, K) and counts the
    launch in ``conv_wgrad_partial.launches``."""
    n, oh, ow, k = dy.shape
    m = ksz * ksz * x.shape[3]
    splits, chunk = splits_for(m, k, n * oh * ow)
    ws = torch.empty((splits, m, k), dtype=torch.float32, device=x.device)
    _launch(0, "conv_wgrad partial", x, dy, ws, ws, ksz, stride, pad,
            splits, chunk)
    conv_wgrad_partial.launches += 1
    return ws


def conv_wgrad_reduce(ws, ksz, c):
    """Launch the reduction kernel over the workspace of
    :func:`conv_wgrad_partial` (slices summed in order); returns dW f32
    HWIO and counts the launch in ``conv_wgrad_reduce.launches``."""
    splits, m, k = ws.shape
    out = torch.empty((ksz, ksz, c, k), dtype=torch.float32, device=ws.device)
    with torch.cuda.device(ws.device):
        stream = torch.cuda.current_stream(ws.device).cuda_stream
        err = _kernel()(1, None, None, ws.data_ptr(), out.data_ptr(), 0, 1,
                        1, 1, c, 1, 1, k, ksz, 1, 0, splits, TILE_L, 0, 0, 0,
                        0, 0, 0, 0, 0, stream)
    if err != 0:
        raise RuntimeError("conv_wgrad reduce launch failed: cudaError %d"
                           % err)
    conv_wgrad_reduce.launches += 1
    return out


conv_wgrad_partial.launches = 0
conv_wgrad_reduce.launches = 0


def wgrad(x, dy, ksz, stride=1, pad=None):
    """dW f32 HWIO (ksz, ksz, C, K) of x (N, H, W, C) and dy (N, OH, OW, K)
    in their own type (f32 or bf16), without :func:`conv_wgrad`'s cast.
    CPU tensors take the plain version; CUDA tensors launch the partial and
    the reduction kernel."""
    if pad is None:
        pad = (ksz - 1) // 2
    _check(x, dy, ksz, stride, pad)
    if x.device.type == "cpu":
        return conv_wgrad_plain(x, dy, ksz, stride, pad)
    if x.device.type != "cuda":
        raise ValueError("conv_wgrad: no path for device %s" % x.device)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError("conv_wgrad kernel takes float32 or bfloat16, not %s"
                        % x.dtype)
    if x.numel() == 0 or dy.numel() == 0:
        raise ValueError("conv_wgrad: empty input %s / %s"
                         % (tuple(x.shape), tuple(dy.shape)))
    ws = conv_wgrad_partial(x, dy, ksz, stride, pad)
    return conv_wgrad_reduce(ws, ksz, x.shape[3])


def conv_wgrad(x, dy, ksz, stride=1, pad=None):
    """The reference's ``conv_wgrad``: x and dy cast to bf16, then
    :func:`wgrad`. Returns f32 HWIO (ksz, ksz, C, K)."""
    return wgrad(x.to(torch.bfloat16), dy.to(torch.bfloat16), ksz, stride,
                 pad)
