"""One LSTM time step: the CUDA kernels' wrapper, their plan and their
plain version.

Replaces ``mxnet_tpu/ops/pallas/lstm.py``'s ``lstm_step`` (the Pallas
kernel ``_step_kernel``); the kernels are ``csrc/lstm_step.cu``, whose
header says what bounds them and what their design does about that.

:func:`lstm_step` keeps the reference's signature and result: ``ib``
(N, 4H) the input projection plus both biases, ``h`` / ``c`` (N, H) the
state and ``wh`` (4H, H) the recurrent weight, gate order i, f, g, o; it
returns (h', c') in h's and c's type, the product and the gate maths in
f32. For CPU tensors the plain version runs; for CUDA tensors :func:`plan`
picks one of three kernels (its ``route``) and the kernel launches,
counting its launches in ``lstm_step.launches``, or the call raises — it
never falls back. Unlike the reference there is no selection gate
(``use_for``): a CUDA tensor always takes a kernel, at any N and H.

- ``"f32"``: float32, register tiles fed by ``cp.async``, at any strides:
  rows that are 16-byte aligned and contiguous in k copy 16 bytes a time,
  others (an odd blob offset, a stride-0 broadcast) 4 bytes a time.
- ``"wgmma"``: bfloat16 with h and wh rows 16-byte aligned, contiguous in
  k and at least H apart, and H a multiple of 16: the tensor cores, fed
  by TMA.
- ``"simt"``: any other bfloat16 layout, read through its strides.

The kernels read ib and c through their strides (``wh`` may be a view into
a packed parameter blob at any offset, ``h`` / ``c`` broadcast views with
stride 0) and write h' and c' into ``h_out`` / ``c_out`` where given
(rows of any stride, columns contiguous, not overlapping an input): the
fused RNN op's scan writes h' straight into its output sequence.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ._launches import counted

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_NAME = "lstm_step"
_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the kernels (csrc/lstm_step.cu), by route, and the route codes of the C
# entry
F32, WGMMA, SIMT = "lstm_f32_kernel", "lstm_wgmma_kernel", "lstm_simt_kernel"
ROUTE_CODE = {"f32": 0, "wgmma": 1, "simt": 2}
# the f32 kernel's (rows, units) a block, by its template argument (rt::Tile)
F32_TILES = {64: (64, 8), 16: (16, 4)}
# batches above this many rows take the 64-row f32 tile
F32_WIDE_ROWS = 32
# the wgmma kernel's rows (one m64 tile) and units a block (wg::BM, BJ)
WG_ROWS, WG_UNITS = 64, 8
# the simt kernel's batch rows per block (csrc/lstm_step.cu simt::ROWS)
ROWS = 32
# (units per warp, warps per block) the simt kernel is built for, in the
# order tiles_for tries them
TILES = ((4, 4), (2, 4), (1, 4), (1, 2), (1, 1))
# blocks a launch aims for: one per SM of the H100's 132
TARGET_BLOCKS = 132

Plan = collections.namedtuple("Plan", "route kernel tile grid vec_h vec_w")
Plan.__doc__ = """How a CUDA call runs. ``route`` "f32" / "wgmma" / "simt";
``kernel`` its name; ``tile`` the kernel's template arguments (f32: rows of
a block, 64 or 16; wgmma: units of a block, 8; simt: (units per warp,
warps)); ``grid`` (unit tiles, row tiles); ``vec_h`` / ``vec_w`` whether
the f32 body copies h / Wh rows 16 bytes a time."""


def _cdiv(a, b):
    return -(-a // b)


def tiles_for(n, hidden):
    """(units per warp, warps) of the simt kernel: the first tile in
    :data:`TILES` that puts at least ``TARGET_BLOCKS`` blocks in flight,
    else the last."""
    for upw, warps in TILES:
        if _cdiv(hidden, upw * warps) * _cdiv(n, ROWS) >= TARGET_BLOCKS:
            return upw, warps
    return TILES[-1]


def _rows16(stride, ptr, item):
    """Whether rows of this (row, column) ``stride`` starting at ``ptr``
    (mod 16) split into 16-byte pieces: unit column stride, every row on a
    16-byte boundary."""
    row, col = stride
    return col == 1 and (row * item) % 16 == 0 and ptr % 16 == 0


@functools.lru_cache(maxsize=1024)
def plan(n, hidden, dtype, h_stride, wh_stride, h_ptr=0, wh_ptr=0):
    """The :class:`Plan` of one CUDA call at batch ``n``, ``hidden`` units,
    ``dtype`` ("float32" or "bfloat16"), h's and wh's (row, column) element
    strides and data pointers (only their value mod 16 counts)."""
    if dtype == "float32":
        bm = 64 if n > F32_WIDE_ROWS else 16
        rows, units = F32_TILES[bm]
        vec = hidden % 4 == 0
        return Plan("f32", F32, bm, (_cdiv(hidden, units), _cdiv(n, rows)),
                    vec and _rows16(h_stride, h_ptr, 4),
                    vec and _rows16(wh_stride, wh_ptr, 4))
    if dtype != "bfloat16":
        raise TypeError("lstm_step kernel takes float32 or bfloat16, not %s"
                        % dtype)
    if hidden % 16 == 0 and all(
            _rows16(st, ptr, 2) and st[0] >= hidden
            for st, ptr in ((h_stride, h_ptr), (wh_stride, wh_ptr))):
        return Plan("wgmma", WGMMA, WG_UNITS,
                    (hidden // WG_UNITS, _cdiv(n, WG_ROWS)), False, False)
    upw, warps = tiles_for(n, hidden)
    return Plan("simt", SIMT, (upw, warps),
                (_cdiv(hidden, upw * warps), _cdiv(n, ROWS)), False, False)


def plan_of(h, wh):
    """:func:`plan` of state ``h`` (N, H) and weight ``wh`` (4H, H)."""
    n, hidden = h.shape
    return plan(n, hidden, str(h.dtype).replace("torch.", ""),
                tuple(h.stride()), tuple(wh.stride()), h.data_ptr() % 16,
                wh.data_ptr() % 16)


def lstm_step_plain(ib, h, c, wh):
    """Plain PyTorch version of the reference's Pallas kernel: the product
    and the gate maths in f32 (f64 for f64 inputs), h' and c' cast to h's
    and c's type."""
    hidden = h.shape[-1]
    acc = torch.promote_types(h.dtype, torch.float32)
    gates = ib.to(acc) + torch.matmul(h.to(acc), wh.to(acc).t())
    i, f, g, o = torch.split(gates, hidden, dim=-1)
    c_new = torch.sigmoid(f) * c.to(acc) + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)


def _check(ib, h, c, wh):
    """Shape/type/device checks shared by both paths."""
    if h.dim() != 2 or c.shape != h.shape or ib.dim() != 2:
        raise ValueError("lstm_step wants ib (N, 4H) and h, c (N, H); got "
                         "ib %s, h %s, c %s" % (tuple(ib.shape),
                                                tuple(h.shape),
                                                tuple(c.shape)))
    n, hidden = h.shape
    if tuple(ib.shape) != (n, 4 * hidden) or tuple(wh.shape) != (
            4 * hidden, hidden):
        raise ValueError("lstm_step: ib %s and wh %s do not match h %s "
                         "(want (N, 4H) and (4H, H))"
                         % (tuple(ib.shape), tuple(wh.shape),
                            tuple(h.shape)))
    if len({t.device for t in (ib, h, c, wh)}) != 1:
        raise ValueError("lstm_step: inputs on different devices")


def _span(t):
    """[first, last) byte addresses a tensor's elements occupy."""
    start = t.data_ptr()
    extent = sum((s - 1) * abs(st) for s, st in zip(t.shape, t.stride()))
    return start, start + (extent + 1) * t.element_size()


def _overlap(a, b):
    (a0, a1), (b0, b1) = _span(a), _span(b)
    return a0 < b1 and b0 < a1


def _output(out, n, hidden, like, inputs, name):
    """``out`` checked (or allocated) as a kernel output."""
    if out is None:
        return torch.empty((n, hidden), dtype=like.dtype, device=like.device)
    if tuple(out.shape) != (n, hidden) or out.dtype != like.dtype \
            or out.device != like.device or out.stride(1) != 1:
        raise ValueError("lstm_step: %s must be (%d, %d) %s on %s with "
                         "contiguous rows, got %s %s stride %s"
                         % (name, n, hidden, like.dtype, like.device,
                            tuple(out.shape), out.dtype, out.stride()))
    if any(_overlap(out, t) for t in inputs):
        raise ValueError("lstm_step: %s overlaps an input" % name)
    return out


def _kernel():
    from . import _build

    return _build.kernel(_NAME, "mxtt_lstm_step",
                         [_PTR] * 6 + [_I32] * 3 + [_I64] * 10
                         + [_I32] * 5 + [_PTR])


def lstm_step(ib, h, c, wh, h_out=None, c_out=None):
    """One fused LSTM step; returns (h', c'). CPU tensors take the plain
    version (copied into ``h_out`` / ``c_out`` where given); CUDA tensors
    launch the kernel of :func:`plan`'s route, which writes them."""
    _check(ib, h, c, wh)
    if h.device.type == "cpu":
        h_new, c_new = lstm_step_plain(ib, h, c, wh)
        if h_out is not None:
            h_new = h_out.copy_(h_new)
        if c_out is not None:
            c_new = c_out.copy_(c_new)
        return h_new, c_new
    if h.device.type != "cuda":
        raise ValueError("lstm_step: no path for device %s" % h.device)
    if not all(t.dtype == h.dtype for t in (ib, c, wh)) \
            or h.dtype not in _DTYPE_CODE:
        raise TypeError("lstm_step kernel takes ib, h, c, wh all float32 or "
                        "all bfloat16, not %s"
                        % [str(t.dtype) for t in (ib, h, c, wh)])
    n, hidden = h.shape
    if n == 0 or hidden == 0:
        raise ValueError("lstm_step: empty state %s" % (tuple(h.shape),))
    inputs = (ib, h, c, wh)
    h_out = _output(h_out, n, hidden, h, inputs, "h_out")
    c_out = _output(c_out, n, hidden, c, inputs + (h_out,), "c_out")
    p = plan_of(h, wh)
    tile, warps = p.tile if p.route == "simt" else (p.tile, 0)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _kernel()(
            ib.data_ptr(), h.data_ptr(), c.data_ptr(), wh.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(), _DTYPE_CODE[h.dtype], n,
            hidden, *ib.stride(), *h.stride(), *c.stride(), *wh.stride(),
            h_out.stride(0), c_out.stride(0), ROUTE_CODE[p.route], tile,
            warps, int(p.vec_h), int(p.vec_w), stream)
    if err != 0:
        raise RuntimeError("lstm_step launch failed (%s route): cudaError "
                           "%d" % (p.route, err))
    lstm_step.launches += 1
    return h_out, c_out


counted(lstm_step)
