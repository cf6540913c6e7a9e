"""Imperative NDArray API.

Counterpart of ``mxnet_tpu/ndarray.py``. An :class:`NDArray` is a mutable
handle over a ``torch.Tensor`` on an explicit device; in-place operations
(``a[:] = x``, ``a += b``, ``copyto``, the fused optimizer updates) write
into that tensor, so every handle and executor dict sharing it sees the
new value. Every registered operator becomes a function of this module
(``nd.<op>``, with ``out=``), generated from the registry at import.
PyTorch runs eagerly, so there is no per-op compile cache.

Creation functions run on the first CUDA card unless ``ctx`` names another
device (``cpu()`` for the host); without a card and without a ``ctx`` they
raise (``context.resolve_device``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import autograd as _autograd
from . import random as _random
from .base import MXNetError
from .context import resolve_device
from .ops import OP_REGISTRY, OpContext, OpDef, get_op

# NB: the generated op functions shadow the builtins sum, max, min and abs
# in this module's namespace.

_TORCH_TO_NP = {torch.float32: np.float32, torch.float64: np.float64,
                torch.float16: np.float16, torch.uint8: np.uint8,
                torch.int32: np.int32, torch.int64: np.int64,
                torch.bool: np.bool_}


def _as_torch_dtype(dtype):
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


class NDArray:
    """Mutable handle over a torch.Tensor."""

    __slots__ = ("_data", "_grad", "__weakref__")

    def __init__(self, data):
        if isinstance(data, NDArray):
            data = data._data
        self._data = data
        self._grad = None

    # --- metadata --------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """The numpy dtype; ``torch.bfloat16`` for bf16 (numpy has none)."""
        np_type = _TORCH_TO_NP.get(self._data.dtype)
        return np.dtype(np_type) if np_type is not None else self._data.dtype

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self) -> torch.device:
        return self._data.device

    ctx = context

    @property
    def grad(self):
        """The gradient buffer :meth:`attach_grad` attached, else None."""
        return self._grad

    # --- sync / transfer --------------------------------------------------
    def wait_to_read(self):
        """Block until the value is computed (reference WaitToRead)."""
        if self._data.device.type == "cuda":
            torch.cuda.synchronize(self._data.device)
        return self

    wait_to_write = wait_to_read

    def asnumpy(self) -> np.ndarray:
        """A host copy, never a view of the array's memory (a host tensor's
        too); bf16 widens to float32 (numpy has no bf16)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def astype(self, dtype):
        """A copy in ``dtype``; a float to an integer type saturates as
        the ``Cast`` op does."""
        from .ops.elemwise import saturating_cast

        return NDArray(saturating_cast(self._data, _as_torch_dtype(dtype)))

    def copy(self) -> "NDArray":
        return NDArray(self._data.clone())

    def copyto(self, other):
        """Copy into another NDArray (in place) or onto a device (new)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError("copyto shape mismatch %s vs %s"
                                 % (other.shape, self.shape))
            other._data.copy_(self._data)
            return other
        return NDArray(self._data.to(resolve_device(other), copy=True))

    def as_in_context(self, ctx) -> "NDArray":
        if resolve_device(ctx) == self.context:
            return self
        return self.copyto(ctx)

    # --- shape ops (views of the same storage where torch allows) --------
    def reshape(self, shape):
        if isinstance(shape, int):
            shape = (shape,)
        return NDArray(self._data.reshape(tuple(shape)))

    T = property(lambda self: NDArray(self._data.t()))

    def slice(self, start, stop):
        return NDArray(self._data[start:stop])

    def flatten(self):
        return NDArray(self._data.reshape(self.shape[0], -1))

    def expand_dims(self, axis):
        return NDArray(self._data.unsqueeze(axis))

    # --- indexing ---------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, NDArray):
            key = key._data.long()
        return NDArray(self._data[key])

    def __setitem__(self, key, value):
        """In-place write; ``a[:] = x`` fills or broadcasts ``x``."""
        if isinstance(key, NDArray):
            key = key._data.long()
        if isinstance(value, NDArray):
            value = value._data
        elif not (isinstance(value, torch.Tensor) or np.isscalar(value)):
            value = torch.as_tensor(np.asarray(value))
        if isinstance(value, torch.Tensor):
            value = value.to(self._data.device, self._data.dtype)
        with torch.no_grad():
            self._data[key] = value

    def __len__(self):
        return self.shape[0]

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

    def __bool__(self):
        return bool(self.asscalar())

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __repr__(self):
        return "<NDArray %s @%s>\n%s" % (
            "x".join(str(s) for s in self.shape), self.context,
            self.asnumpy())

    # --- arithmetic -------------------------------------------------------
    def _binop(self, other, op, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return invoke(get_op(op), [a, b], {})[0]
        name = scalar_op.replace("_", "_r", 1) if reverse else scalar_op
        return invoke(get_op(name), [self], {"scalar": float(other)})[0]

    def __add__(self, other):
        return self._binop(other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binop(other, "broadcast_sub", "_minus_scalar",
                           reverse=True)

    def __mul__(self, other):
        return self._binop(other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binop(other, "broadcast_div", "_div_scalar",
                           reverse=True)

    def __mod__(self, other):
        return self._binop(other, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, other):
        return self._binop(other, "broadcast_mod", "_mod_scalar",
                           reverse=True)

    def __pow__(self, other):
        return self._binop(other, "broadcast_power", "_power_scalar")

    def __rpow__(self, other):
        return self._binop(other, "broadcast_power", "_power_scalar",
                           reverse=True)

    def __neg__(self):
        return invoke(get_op("negative"), [self], {})[0]

    def __abs__(self):
        return invoke(get_op("abs"), [self], {})[0]

    def _inplace(self, result):
        self[:] = result
        return self

    def __iadd__(self, other):
        return self._inplace(self + other)

    def __isub__(self, other):
        return self._inplace(self - other)

    def __imul__(self, other):
        return self._inplace(self * other)

    def __itruediv__(self, other):
        return self._inplace(self / other)

    def __eq__(self, other):
        if isinstance(other, (NDArray, int, float)):
            return self._binop(other, "broadcast_equal", "_equal_scalar")
        return NotImplemented

    def __ne__(self, other):
        if isinstance(other, (NDArray, int, float)):
            return self._binop(other, "broadcast_not_equal",
                               "_not_equal_scalar")
        return NotImplemented

    def __gt__(self, other):
        return self._binop(other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binop(other, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binop(other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binop(other, "broadcast_lesser_equal",
                           "_lesser_equal_scalar")

    __hash__ = object.__hash__

    # --- autograd (reference ndarray.py attach_grad / backward) -----------
    def attach_grad(self, grad_req="write"):
        """Attach a zeroed gradient buffer (``.grad``) and mark this array
        as a variable of :func:`autograd.backward`."""
        grad = NDArray(torch.zeros_like(self._data.detach()))
        _autograd.mark_variables([self], [grad], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Gradients of this array into the marked variables' buffers."""
        _autograd.backward([self], None if out_grad is None else [out_grad],
                           retain_graph=retain_graph, train_mode=train_mode)

    # reductions mirroring the reference's methods
    def sum(self, axis=None, keepdims=False):
        return invoke(get_op("sum"), [self],
                      {"axis": axis, "keepdims": keepdims})[0]

    def mean(self, axis=None, keepdims=False):
        return invoke(get_op("mean"), [self],
                      {"axis": axis, "keepdims": keepdims})[0]

    def max(self, axis=None, keepdims=False):
        return invoke(get_op("max"), [self],
                      {"axis": axis, "keepdims": keepdims})[0]

    def min(self, axis=None, keepdims=False):
        return invoke(get_op("min"), [self],
                      {"axis": axis, "keepdims": keepdims})[0]


# --- imperative invoke --------------------------------------------------------
def invoke(op: OpDef, inputs: Sequence[NDArray], attrs: Dict[str, Any],
           out=None) -> List[NDArray]:
    """Run one operator eagerly (reference MXImperativeInvoke). ``inputs``
    is ordered arg_names + aux_names; aux handles are updated in place.
    With ``out``, results are written into those handles (skipped where
    the op already updated them in place) and the handles returned.

    Inside ``autograd.record()`` the op runs with grad enabled, so its
    outputs join the graph ``autograd.backward`` differentiates; the op
    sees ``is_train`` from the training flag (reference
    ndarray.py:360-366)."""
    attrs = op.parse_attrs(attrs)
    n_aux = 0 if op.variadic else len(op.get_aux_names(attrs))
    n_in = len(inputs) - n_aux
    rng = None
    if op.needs_rng:
        rng = _random.generator(inputs[0].context if inputs
                                else resolve_device(attrs.get("ctx")))
    with torch.set_grad_enabled(_autograd.is_recording()):
        outs, aux_out = op.impl(
            attrs, tuple(x._data for x in inputs[:n_in]),
            tuple(x._data for x in inputs[n_in:]),
            OpContext(is_train=_autograd.is_training(), rng=rng))
    with torch.no_grad():
        for handle, new in zip(inputs[n_in:], aux_out):
            handle._data.copy_(new)
        if out is None:
            return [NDArray(o) for o in outs]
        if isinstance(out, NDArray):
            out = [out]
        for tgt, res in zip(out, outs):
            if tgt._data is not res:
                tgt._data.copy_(res)
    return list(out)


def _split_args(op: OpDef, args, kwargs):
    """Split user args/kwargs into (ordered inputs, attr dict)."""
    tensor_kwargs, attrs = {}, {}
    for k, v in kwargs.items():
        (tensor_kwargs if isinstance(v, NDArray) else attrs)[k] = v
    attrs.pop("name", None)
    if op.variadic:
        return (list(args) + [tensor_kwargs[k]
                              for k in sorted(tensor_kwargs)]), attrs
    parsed = op.parse_attrs(attrs)
    names = list(op.get_arg_names(parsed)) + list(op.get_aux_names(parsed))
    inputs: List[Optional[NDArray]] = [None] * len(names)
    for i, a in enumerate(args):
        inputs[i] = a
    for k, v in tensor_kwargs.items():
        if k not in names:
            raise MXNetError("%s: unexpected tensor argument %r"
                             % (op.name, k))
        inputs[names.index(k)] = v
    missing = [n for n, x in zip(names, inputs) if x is None]
    if missing:
        raise MXNetError("%s missing inputs %s" % (op.name, missing))
    return inputs, attrs


def _make_nd_function(op: OpDef):
    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        inputs, attrs = _split_args(op, args, kwargs)
        results = invoke(op, inputs, attrs, out=out)
        if op.get_num_outputs(op.parse_attrs(attrs)) == 1:
            return results[0]
        return results

    fn.__name__ = op.py_name or op.name
    fn.__doc__ = op.doc
    return fn


def _populate_namespace():
    g = globals()
    made = {}
    for name, op in OP_REGISTRY.items():
        if id(op) not in made:
            made[id(op)] = _make_nd_function(op)
        target = made[id(op)]
        g.setdefault(name, target)
        g.setdefault(op.py_name or name, target)


# --- creation / utility -------------------------------------------------------
def array(source, ctx=None, dtype=None) -> NDArray:
    """An NDArray copied from ``source`` onto ``ctx`` (default: the card).
    Python lists and float64 numpy arrays become float32, as in the
    reference; other numpy arrays keep their type."""
    if isinstance(source, NDArray):
        source = source.asnumpy()
    was_ndarray = isinstance(source, np.ndarray)
    arr = np.asarray(source)
    if dtype is None and (not was_ndarray or arr.dtype == np.float64):
        arr = arr.astype(np.float32)
    device = resolve_device(ctx)
    # a copy on every device: torch.as_tensor shares a CPU array's memory
    t = torch.tensor(arr, device=device)
    if dtype is not None:
        t = t.to(_as_torch_dtype(dtype))
    return NDArray(t)


def _filled(fill, shape, ctx, dtype):
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.full(tuple(shape), fill, dtype=_as_torch_dtype(dtype),
                              device=resolve_device(ctx)))


def zeros(shape, ctx=None, dtype=None) -> NDArray:
    return _filled(0, shape, ctx, dtype)


def ones(shape, ctx=None, dtype=None) -> NDArray:
    return _filled(1, shape, ctx, dtype)


def full(shape, val, ctx=None, dtype=None) -> NDArray:
    return _filled(val, shape, ctx, dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype="float32") -> NDArray:
    """numpy's ``arange(start, stop, step)`` in ``dtype``, each value
    ``repeat`` times, on ``ctx`` (default: the card)."""
    out = np.arange(start, stop, step, dtype=np.dtype(dtype))
    if repeat != 1:
        out = np.repeat(out, repeat)
    return array(out, ctx=ctx, dtype=dtype)


def empty(shape, ctx=None, dtype=None) -> NDArray:
    """Zero-filled, like the reference's ``empty``."""
    return zeros(shape, ctx, dtype)


def concatenate(arrays: Sequence[NDArray], axis=0,
                always_copy=True) -> NDArray:
    """The arrays joined along ``axis``, as a new array on their device."""
    del always_copy  # torch.cat always copies
    return NDArray(torch.cat([a._data for a in arrays], dim=axis))


def moveaxis(tensor: NDArray, source, destination) -> NDArray:
    """``tensor`` with axis ``source`` moved to ``destination`` (a view)."""
    return NDArray(torch.movedim(tensor._data, source, destination))


def onehot_encode(indices: NDArray, out: NDArray) -> NDArray:
    """One-hot of ``indices`` into ``out`` (its second axis the depth), in
    place; returns ``out`` (reference ``_onehot_encode``)."""
    res = invoke(get_op("one_hot"), [indices], {"depth": out.shape[1]})[0]
    out[:] = res
    return out


# --- save / load (the checkpoint container, reference ndarray.h:334-343) -----
def save(fname: str, data, format: str = "npz") -> None:
    """Save an NDArray, a list or a dict of them: by default the JAX
    package's npz container (``__format__`` "dict" or "list", list entries
    as ``arr_<i>``), written at ``fname`` itself; ``format="reference"``
    the reference's dmlc ``.params`` blob (``interop.save_params``).
    :func:`load` reads either, and so does the JAX package."""
    import os

    if format not in ("npz", "reference"):
        raise ValueError("nd.save format must be 'npz' or 'reference', "
                         "got %r" % (format,))
    if isinstance(data, NDArray):
        data = [data]
    if format == "reference":
        from . import interop

        interop.save_params(fname, data)
        return
    if isinstance(data, dict):
        np.savez(fname, __format__="dict",
                 **{k: v.asnumpy() for k, v in data.items()})
    else:
        np.savez(fname, __format__="list",
                 **{"arr_%d" % i: v.asnumpy() for i, v in enumerate(data)})
    if not fname.endswith(".npz") and os.path.exists(fname + ".npz"):
        os.replace(fname + ".npz", fname)


def load(fname: str):
    """The dict or list :func:`save` wrote (either format, told apart by
    the first 8 bytes), as NDArrays on the host."""
    from . import interop
    from .context import cpu

    with open(fname, "rb") as fh:
        head = fh.read(8)
    if interop.is_reference_params(head):
        return interop.load_params(fname)
    with np.load(fname, allow_pickle=False) as f:
        fmt = str(f["__format__"]) if "__format__" in f.files else "dict"
        if fmt == "list":
            keys = sorted((k for k in f.files if k.startswith("arr_")),
                          key=lambda k: int(k.split("_")[1]))
            return [array(f[k], ctx=cpu()) for k in keys]
        return {k: array(f[k], ctx=cpu()) for k in f.files
                if k != "__format__"}


def waitall():
    """Block on all outstanding work on the card (reference WaitForAll)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


_populate_namespace()
