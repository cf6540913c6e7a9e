"""Shape, indexing and ordering operators.

Counterpart of ``mxnet_tpu/ops/matrix.py`` (reference
src/operator/tensor/matrix_op.cc, indexing_op.cc, ordering_op.cc,
swapaxis.cc, concat.cc, slice_channel.cc, dot.cc, pad.cc): ``Reshape``
with the reference's special codes, ``dot`` / ``batch_dot``,
``transpose``, ``Flatten``, ``SwapAxis``, ``expand_dims``, ``slice`` /
``slice_axis``, ``Concat``, ``SliceChannel``, ``tile``, ``repeat``,
``reverse``, ``Pad``, ``Embedding``, ``take`` / ``batch_take``,
``one_hot``, ``sort`` / ``argsort`` / ``topk``, and ``quantized_matmul``
(the quantized serving path's product). The shape ops return views where
torch can.

The ordering ops copy the JAX package's: sorts are stable, ``topk`` puts
the lower index first among equal values, and ``argsort`` / ``topk``
return indices in the data's type whatever ``dtype`` says.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .contrib import symmetric_scale
from .kernels import _launches
from .registry import alias, defop


def _infer_reshape(data_shape, target):
    """The reference's reshape codes (matrix_op.cc ReshapeShape): 0 copies
    a source dim, -1 is inferred, -2 copies the rest, -3 merges two source
    dims, -4 splits one into the next two target entries (either may be
    -1); an explicit dim consumes one source dim too."""
    out = []
    src = list(data_shape)
    i = 0  # index into src
    t = list(target)
    j = 0
    while j < len(t):
        k = t[j]
        if k == 0:
            out.append(src[i])
            i += 1
        elif k == -1:
            out.append(-1)
            i = min(i + 1, len(src))
        elif k == -2:
            out.extend(src[i:])
            i = len(src)
        elif k == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif k == -4:
            a, b = t[j + 1], t[j + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        else:
            out.append(int(k))
            i = min(i + 1, len(src))
        j += 1
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1])) or 1
        total = int(np.prod(data_shape)) if data_shape else 1
        out[out.index(-1)] = total // known
    return tuple(out)


@defop("Reshape", arg_names=("data",),
       param_spec={"shape": (), "reverse": False, "target_shape": (),
                   "keep_highest": False})
def _reshape(attrs, data):
    """Reshape with the 0/-1/-2/-3/-4 codes; ``reverse=True`` matches the
    codes from the right."""
    shape = tuple(attrs["shape"]) or tuple(attrs["target_shape"])
    dims = tuple(data.shape)
    if attrs["reverse"]:
        inferred = _infer_reshape(dims[::-1], shape[::-1])[::-1]
    else:
        inferred = _infer_reshape(dims, shape)
    return data.reshape(inferred)


alias("Reshape", "reshape")


@defop("dot", arg_names=("lhs", "rhs"),
       param_spec={"transpose_a": False, "transpose_b": False})
def _dot(attrs, lhs, rhs):
    """Matrix product (reference dot.cc): the last axis of lhs contracts
    with the first of rhs; ``transpose_a`` / ``transpose_b`` move the
    contracted axis first (last) beforehand."""
    if attrs["transpose_a"]:
        lhs = lhs.movedim(0, -1) if lhs.dim() > 2 else lhs.t()
    if attrs["transpose_b"]:
        rhs = rhs.movedim(-1, 0) if rhs.dim() > 2 else rhs.t()
    if lhs.dim() == 1 and rhs.dim() == 1:
        return torch.dot(lhs, rhs)
    return torch.tensordot(lhs, rhs, dims=([lhs.dim() - 1], [0]))


@defop("batch_dot", arg_names=("lhs", "rhs"),
       param_spec={"transpose_a": False, "transpose_b": False})
def _batch_dot(attrs, lhs, rhs):
    """Batched product over the leading axis (reference dot.cc batch_dot);
    ``transpose_a`` / ``transpose_b`` swap the last two axes first."""
    if attrs["transpose_a"]:
        lhs = lhs.transpose(-1, -2)
    if attrs["transpose_b"]:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


#: ``torch._int_mm`` on a CUDA tensor (cuBLASLt) takes more than 16 rows
#: and K, N multiples of 8: fewer rows are padded with zero rows to
#: INT_MM_PAD_ROWS, and the pad is sliced off the result
INT_MM_MIN_ROWS = 17
INT_MM_PAD_ROWS = 32


@_launches.counted
def int8_product(xq, w):
    """``xq (M, K) int8 @ w (N, K) int8 .T`` -> (M, N) int32, exact (int32
    accumulation: the same integers on every device and in every order).
    One ``torch._int_mm`` (cuBLASLt on the card), counted in
    ``int8_product.launches``. On the card a shape it cannot take raises;
    nothing widens the operands instead."""
    m, k = xq.shape
    n = w.shape[0]
    _launches.launched(int8_product, xq.dtype)
    if not xq.is_cuda:
        return torch._int_mm(xq, w.t())
    if k % 8 or n % 8:
        raise MXNetError("quantized_matmul: the int8 product on the card "
                         "needs K and N multiples of 8, got K=%d, N=%d"
                         % (k, n))
    if m >= INT_MM_MIN_ROWS:
        return torch._int_mm(xq, w.t())
    pad = xq.new_zeros((INT_MM_PAD_ROWS - m, k))
    return torch._int_mm(torch.cat([xq, pad]), w.t())[:m]


def quantized_matmul(x, w, scale, act_dtype="int8"):
    """``x @ dequant(w).T`` for a per-channel quantized weight
    (``mxnet_tpu/ops/matrix.py`` ``quantized_matmul``).

    ``w``: (O, I) int8 or fp8-e4m3, ``scale``: (O,) or (O, 1) f32. Two
    strategies, by ``act_dtype``:

    - ``"int8"`` (int8 weights): dynamic per-row symmetric quantization of
      the activations, then :func:`int8_product` (int32), rescaled in
      f32 as ``acc * xs * scale`` in the reference's order;
    - ``"bf16"`` / ``"float32"`` (and every fp8 weight): dequant on load,
      the weight widened then scaled in the compute type, then a product
      with f32 results (bf16 on the card: ``torch.mm(..., out_dtype=
      float32)``; on the CPU the bf16 values' f32 product, as XLA's
      ``preferred_element_type``).

    Returns f32 of shape ``x.shape[:-1] + (O,)``."""
    scale = scale.reshape(-1)
    out_shape = x.shape[:-1] + (w.shape[0],)
    x2 = x.reshape(-1, x.shape[-1])
    if w.dtype == torch.int8 and act_dtype == "int8":
        xs = symmetric_scale(x2.abs().amax(dim=1, keepdim=True), 127.0)
        xq = torch.round(x2 / xs).to(torch.int8)
        acc = int8_product(xq, w)
        out = acc.to(torch.float32) * xs * scale[None, :]
    elif act_dtype == "bf16":
        wf = w.to(torch.bfloat16) * scale[:, None].to(torch.bfloat16)
        xb = x2.to(torch.bfloat16)
        if xb.is_cuda:
            out = torch.mm(xb, wf.t(), out_dtype=torch.float32)
        else:
            out = xb.float() @ wf.float().t()
    else:
        wf = w.to(torch.float32) * scale[:, None].to(torch.float32)
        out = x2.to(torch.float32) @ wf.t()
    return out.reshape(out_shape)


@defop("transpose", arg_names=("data",), param_spec={"axes": ()})
def _transpose(attrs, data):
    """Permute the axes (empty ``axes``: reverse them); a view."""
    axes = tuple(int(a) for a in attrs["axes"]) or \
        tuple(reversed(range(data.dim())))
    return data.permute(axes)


@defop("Flatten", arg_names=("data",), param_spec={})
def _flatten(attrs, data):
    """Collapse all but the leading axis."""
    return data.reshape(data.shape[0], -1)


alias("Flatten", "flatten")


@defop("SwapAxis", arg_names=("data",), param_spec={"dim1": 0, "dim2": 0})
def _swapaxis(attrs, data):
    """Swap two axes (a view)."""
    return data.transpose(int(attrs["dim1"]), int(attrs["dim2"]))


alias("SwapAxis", "swapaxes")


@defop("expand_dims", arg_names=("data",), param_spec={"axis": 0})
def _expand_dims(attrs, data):
    """A new axis of size 1 at ``axis`` (negative counts from the end of
    the result, as ``jnp.expand_dims``)."""
    return data.unsqueeze(int(attrs["axis"]))


@defop("slice_axis", arg_names=("data",),
       param_spec={"axis": 0, "begin": 0, "end": None})
def _slice_axis(attrs, data):
    """``data[begin:end]`` along ``axis``, as a Python slice: ``end`` None
    is the axis' size, and a negative ``begin`` or ``end`` counts from
    it."""
    ax = int(attrs["axis"]) % data.dim()
    end = attrs["end"]
    begin, end, _ = slice(int(attrs["begin"]),
                          None if end is None else int(end)).indices(
                              data.shape[ax])
    return data.narrow(ax, begin, max(0, end - begin))


@defop("slice", arg_names=("data",), param_spec={"begin": (), "end": ()})
def _slice(attrs, data):
    """``data[b0:e0, b1:e1, ...]`` as Python slices (None an open end,
    negatives from the end), the axes past ``begin`` whole (reference
    matrix_op.cc slice / crop); a view."""
    return data[tuple(
        slice(None if b is None else int(b), None if e is None else int(e))
        for b, e in zip(attrs["begin"], attrs["end"]))]


alias("slice", "crop")


@defop("Concat", arg_names=(), variadic=True,
       param_spec={"num_args": 0, "dim": 1}, py_name="concat")
def _concat(attrs, *inputs):
    """Concatenate the inputs along ``dim``."""
    return torch.cat(inputs, dim=int(attrs["dim"]))


alias("Concat", "concat")


@defop("SliceChannel", arg_names=("data",),
       param_spec={"num_outputs": 1, "axis": 1, "squeeze_axis": False},
       num_outputs=lambda attrs: int(attrs["num_outputs"]), py_name="split")
def _slice_channel(attrs, data):
    """Split ``axis`` into ``num_outputs`` equal parts (views), each
    without that axis if ``squeeze_axis``."""
    n, ax = int(attrs["num_outputs"]), int(attrs["axis"])
    if data.shape[ax] % n:
        raise ValueError("SliceChannel: axis %d of size %d does not split "
                         "into %d equal parts" % (ax, data.shape[ax], n))
    parts = torch.split(data, data.shape[ax] // n, dim=ax)
    if attrs["squeeze_axis"]:
        parts = [p.squeeze(ax) for p in parts]
    return tuple(parts)


alias("SliceChannel", "split")


@defop("repeat", arg_names=("data",), param_spec={"repeats": 1, "axis": None})
def _repeat(attrs, data):
    """Repeat each element ``repeats`` times along ``axis`` (None: of the
    flattened data), as ``np.repeat``."""
    ax = attrs["axis"]
    return torch.repeat_interleave(data, int(attrs["repeats"]),
                                   dim=None if ax is None else int(ax))


@defop("tile", arg_names=("data",), param_spec={"reps": ()})
def _tile(attrs, data):
    """``np.tile``: ``reps`` shorter than the data's axes is padded with
    leading 1s, longer adds leading axes."""
    return torch.tile(data, tuple(int(r) for r in attrs["reps"]))


@defop("reverse", arg_names=("data",), param_spec={"axis": ()})
def _reverse(attrs, data):
    """Reverse the order along ``axis`` (one or a tuple)."""
    axes = attrs["axis"]
    if isinstance(axes, (int, np.integer)):
        axes = (axes,)
    return torch.flip(data, dims=tuple(int(a) for a in axes))


alias("reverse", "flip")


def _pad_index(n, lo, hi, mode, device):
    """Source index of each position of an axis of ``n`` padded by (lo,
    hi): ``edge`` repeats the end, ``reflect`` mirrors about it without
    repeating it (``np.pad``'s modes)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


@defop("Pad", arg_names=("data",),
       param_spec={"mode": "constant", "pad_width": (),
                   "constant_value": 0.0})
def _pad(attrs, data):
    """Pad every axis by (``pad_width[2i]``, ``pad_width[2i + 1]``) with
    ``constant_value``, or the edge (``edge``), or the mirror image
    (``reflect``) (reference src/operator/pad.cc). The edge and reflect
    modes gather along each padded axis: ``F.pad`` takes them only on the
    last three axes."""
    pw = [int(p) for p in attrs["pad_width"]]
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    if attrs["mode"] == "constant":
        flat = [p for pair in reversed(pairs) for p in pair]
        return torch.nn.functional.pad(data, flat,
                                       value=float(attrs["constant_value"]))
    for ax, (lo, hi) in enumerate(pairs):
        if lo or hi:
            data = data.index_select(ax, _pad_index(
                data.shape[ax], lo, hi, attrs["mode"], data.device))
    return data


alias("Pad", "pad")


@defop("Embedding", arg_names=("data", "weight"),
       param_spec={"input_dim": 0, "output_dim": 0, "dtype": "float32"},
       no_grad_inputs=("data",))
def _embedding(attrs, data, weight):
    """Table lookup. The ids (float, as the reference feeds them) are cast
    to int64, so ``data`` gets no gradient; the weight's gradient is the
    scatter-add of the output gradient at the ids. Ids outside [0, n)
    follow the JAX package's ``jnp.take``: -n <= i < 0 reads row n + i,
    and any other id a NaN row, whose gradient reaches no row."""
    n = weight.shape[0]
    ids = data.long()
    ids = torch.where(ids < 0, ids + n, ids)
    inside = (ids >= 0) & (ids < n)
    out = torch.nn.functional.embedding(torch.where(inside, ids, 0), weight)
    return out.masked_fill(~inside.unsqueeze(-1), float("nan"))


@defop("take", arg_names=("a", "indices"),
       param_spec={"axis": 0, "mode": "clip"}, no_grad_inputs=("indices",))
def _take(attrs, a, indices):
    """Gather along ``axis`` at ``indices`` (float ids, truncated): the
    result is a's axes before ``axis``, the indices' shape, a's axes after.
    An id outside [0, n) clips to 0 or n - 1 (a negative id to 0, not to
    Python's end-relative row), or wraps modulo n with ``mode="wrap"``.
    The gradient is a scatter-add (``index_add_``: on the card its atomics
    add in no fixed order)."""
    ax = int(attrs["axis"]) % a.dim()
    n = a.shape[ax]
    idx = indices.long().reshape(-1)
    idx = torch.remainder(idx, n) if attrs["mode"] == "wrap" \
        else idx.clamp(0, n - 1)
    out = a.index_select(ax, idx)
    return out.reshape(a.shape[:ax] + indices.shape + a.shape[ax + 1:])


@defop("batch_take", arg_names=("a", "indices"), param_spec={},
       no_grad_inputs=("indices",))
def _batch_take(attrs, a, indices):
    """``out[i] = a[i, indices[i]]`` over a (N, M), shaped as
    ``indices``. As the JAX package's ``take_along_axis``: -M <= id < 0
    reads M + id, any other id outside [0, M) gives NaN and no
    gradient."""
    m = a.shape[1]
    ids = indices.long().reshape(-1, 1)
    ids = torch.where(ids < 0, ids + m, ids)
    inside = (ids >= 0) & (ids < m)
    out = torch.gather(a, 1, torch.where(inside, ids, 0))
    return out.masked_fill(~inside, float("nan")).reshape(indices.shape)


@defop("one_hot", arg_names=("indices",),
       param_spec={"depth": 0, "on_value": 1.0, "off_value": 0.0,
                   "dtype": "float32"},
       no_grad_inputs=("indices",))
def _one_hot(attrs, indices):
    """One-hot over a new last axis of ``depth``; out-of-range ids give an
    all-off row, as ``jax.nn.one_hot``."""
    classes = torch.arange(int(attrs["depth"]), device=indices.device)
    hit = indices.long().unsqueeze(-1) == classes
    dtype = getattr(torch, str(np.dtype(attrs["dtype"])))
    on, off = float(attrs["on_value"]), float(attrs["off_value"])
    return hit.to(dtype) * (on - off) + off


# --- ordering (reference ordering_op.cc) -------------------------------------
@defop("sort", arg_names=("data",), param_spec={"axis": -1, "is_ascend": True})
def _sort(attrs, data):
    """Sorted along ``axis`` (None: the flattened data), ascending, or
    its reverse with ``is_ascend=False``."""
    ax = attrs["axis"]
    if ax is None:
        data, ax = data.reshape(-1), -1
    out = torch.sort(data, dim=int(ax), stable=True).values
    return out if attrs["is_ascend"] else torch.flip(out, dims=(int(ax),))


@defop("argsort", arg_names=("data",),
       param_spec={"axis": -1, "is_ascend": True, "dtype": "float32"})
def _argsort(attrs, data):
    """The stable ascending order's indices along ``axis`` (None: of the
    flattened data); descending is the ascending order of ``-data``, so
    ties stay in index order either way. Indices in the data's type."""
    ax = attrs["axis"]
    if ax is None:
        data, ax = data.reshape(-1), -1
    key = data if attrs["is_ascend"] else -data
    return torch.argsort(key, dim=int(ax), stable=True).to(data.dtype)


def stable_topk(data, k, largest=True):
    """The indices of the ``k`` largest (``largest=False``: smallest)
    entries along the last axis, the lower index first among equal values
    (``jax.lax.top_k``'s order; ``torch.topk``'s order of ties is
    unspecified on the card, so a stable sort picks them)."""
    return torch.sort(data, dim=-1, descending=largest,
                      stable=True).indices[..., :k]


@defop("topk", arg_names=("data",),
       param_spec={"axis": -1, "k": 1, "ret_typ": "indices",
                   "is_ascend": False, "dtype": "float32"},
       num_outputs=lambda attrs: 2 if attrs.get("ret_typ") == "both" else 1)
def _topk(attrs, data):
    """The ``k`` largest (``is_ascend``: smallest) along ``axis``, the
    lower index first among equal values (:func:`stable_topk`).
    ``ret_typ``: ``indices`` (in the data's type), ``value``, ``both``, or
    ``mask`` (1 at the k picked)."""
    ax = int(attrs["axis"]) % data.dim()
    k = int(attrs["k"])
    moved = data.movedim(ax, -1)
    idx = stable_topk(moved, k, largest=not attrs["is_ascend"])
    rt = attrs["ret_typ"]
    if rt == "mask":
        mask = torch.zeros_like(moved).scatter(-1, idx, 1.0)
        return mask.movedim(-1, ax)
    vals = torch.gather(moved, -1, idx).movedim(-1, ax)
    idxf = idx.movedim(-1, ax).to(data.dtype)
    if rt == "value":
        return vals
    if rt == "both":
        return vals, idxf
    return idxf
