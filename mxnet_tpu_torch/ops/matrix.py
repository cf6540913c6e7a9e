"""Shape and indexing operators.

Counterpart of the parts of ``mxnet_tpu/ops/matrix.py`` the ported paths
use (reference src/operator/tensor/matrix_op.cc, indexing_op.cc,
swapaxis.cc, concat.cc, slice_channel.cc): ``Reshape`` with the
reference's special codes, ``Flatten``, ``SwapAxis``, ``expand_dims``,
``slice_axis``, ``Concat``, ``SliceChannel``, ``Embedding`` and
``one_hot``. The shape ops return views where torch can.
"""
from __future__ import annotations

import numpy as np
import torch

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
    """``data[begin:end]`` along ``axis``; ``end`` None is the axis' size
    and a negative ``end`` counts from it."""
    ax = int(attrs["axis"]) % data.dim()
    end = attrs["end"]
    end = data.shape[ax] if end is None else int(end)
    if end < 0:
        end += data.shape[ax]
    return data.narrow(ax, int(attrs["begin"]), end - int(attrs["begin"]))


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


@defop("Embedding", arg_names=("data", "weight"),
       param_spec={"input_dim": 0, "output_dim": 0, "dtype": "float32"},
       no_grad_inputs=("data",))
def _embedding(attrs, data, weight):
    """Table lookup. The ids (float, as the reference feeds them) are cast
    to int64, so ``data`` gets no gradient; the weight's gradient is the
    scatter-add of the output gradient at the ids."""
    return torch.nn.functional.embedding(data.long(), weight)


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
