"""Custom operators written in Python.

Counterpart of ``mxnet_tpu/operator.py`` (reference python/mxnet/
operator.py ``CustomOp`` / ``CustomOpProp`` / ``register``, and the native
bridge src/operator/custom/custom.cc). A Custom op runs inside the graph
as a ``torch.autograd.Function`` whose forward and backward call the
user's ``CustomOp``.

The JAX package hands the user numpy-backed host tensors, because it has
to leave XLA through ``pure_callback``. The port has no such wall: like
the reference MXNet (custom.cc wraps the TBlobs on the op's context), it
hands the user port ``NDArray``s over the op's **device** tensors. So
``asnumpy()`` copies to the host and ``x[:] = v`` takes numpy, an NDArray
or a tensor: numpy-style ops run unchanged, and ops that launch kernels
(``mx.rtc``) push the device tensors without leaving the card.

The operator is created once per bound graph node (``OpContext.memo``),
for its input shapes, types and device, as the reference creates it at
bind; an imperative call creates one per call.

    @mx.operator.register("softmax")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)
        def list_arguments(self): return ['data', 'label']
        def infer_shape(self, in_shape): ...
        def create_operator(self, ctx, shapes, dtypes): return Softmax()

    out = mx.nd.Custom(data, label, op_type='softmax')
    s = mx.sym.Custom(data=d, label=l, op_type='softmax')
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .base import MXNetError
from .ndarray import _TORCH_TO_NP, NDArray, _as_torch_dtype

# op_type -> CustomOpProp subclass (reference CustomOpProp::registry_)
_CUSTOM_OP_REGISTRY: Dict[str, type] = {}
_REQS = {0: "null", 1: "write", 2: "inplace", 3: "add"}


class CustomOp:
    """Base class of a custom operator's implementation (reference
    operator.py ``CustomOp``): override ``forward`` and ``backward``.
    ``copies_to_host`` says the op reads its arrays on the host, which a
    training step captured as a CUDA graph cannot hold."""

    copies_to_host = False

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    @staticmethod
    def assign(dst, req, src):
        """Write ``src`` (numpy, an NDArray, a tensor or a scalar) into the
        NDArray ``dst`` as ``req`` says (operator.h:24-37): "null" skips,
        "write" and "inplace" overwrite, "add" accumulates. The write goes
        into ``dst``'s storage under ``no_grad``."""
        req = _REQS.get(req, req)
        if req == "null":
            return
        if req not in ("write", "inplace", "add"):
            raise MXNetError("unknown req %r" % (req,))
        if isinstance(src, NDArray):
            src = src._data
        elif not isinstance(src, torch.Tensor):
            src = torch.as_tensor(np.asarray(src))
        with torch.no_grad():
            src = src.to(dst._data.device, dst._data.dtype)
            if req == "add":
                dst._data.add_(src)
            else:
                dst._data.copy_(src)


class CustomOpProp:
    """A custom operator's metadata (reference operator.py
    ``CustomOpProp``; OperatorProperty, operator.h:166-480)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        """Default: every output takes the first input's shape."""
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        """Default: every output and aux state takes the first input's
        type."""
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


def register(reg_name: str):
    """Register a CustomOpProp subclass under ``op_type=reg_name``
    (reference operator.py ``register``)."""

    def dec(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("custom op %r must subclass CustomOpProp"
                             % reg_name)
        _CUSTOM_OP_REGISTRY[reg_name] = prop_cls
        return prop_cls

    return dec


def get_prop_cls(op_type: str) -> type:
    try:
        return _CUSTOM_OP_REGISTRY[op_type]
    except KeyError:
        raise MXNetError("custom op type %r is not registered (known: %s)"
                         % (op_type, sorted(_CUSTOM_OP_REGISTRY))) from None


def make_prop(attrs: Dict[str, Any]) -> CustomOpProp:
    """The prop of a Custom op's attributes: every attribute but
    ``op_type`` goes to the prop's constructor as a string, as the
    reference marshals them through the C bridge."""
    if "op_type" not in attrs:
        raise MXNetError("Custom requires parameter 'op_type'")
    kwargs = {k: str(v) for k, v in attrs.items() if k != "op_type"}
    return get_prop_cls(str(attrs["op_type"]))(**kwargs)


def _np_dtype(dtype: torch.dtype):
    """The numpy type a prop sees for a tensor type (bf16, which numpy
    lacks, stays ``torch.bfloat16``)."""
    np_type = _TORCH_TO_NP.get(dtype)
    return np.dtype(np_type) if np_type is not None else dtype


def _output_specs(prop: CustomOpProp, in_shapes, in_dtypes):
    """[(shape, torch dtype)] of the outputs, from the prop's
    ``infer_shape`` and ``infer_type``; no user operator code runs."""
    _, out_shapes, _ = prop.infer_shape([list(s) for s in in_shapes])
    _, out_types, _ = prop.infer_type([_np_dtype(d) for d in in_dtypes])
    return [(tuple(int(x) for x in s), _as_torch_dtype(t))
            for s, t in zip(out_shapes, out_types)]


def _backward_deps(prop: CustomOpProp, n_in: int, n_out: int):
    """(input indices, output indices) that the op's backward reads, from
    the prop's ``declare_backward_dependency`` over distinct ids, as the
    reference's custom.cc asks it which arrays to keep."""
    out_grad = list(range(n_out))
    in_data = list(range(n_out, n_out + n_in))
    out_data = list(range(n_out + n_in, 2 * n_out + n_in))
    deps = set(prop.declare_backward_dependency(out_grad, in_data, out_data))
    return (tuple(i for i in range(n_in) if in_data[i] in deps),
            tuple(j for j in range(n_out) if out_data[j] in deps))


def _unkept(t: torch.Tensor) -> NDArray:
    """An NDArray that stands for an array the backward did not declare:
    its shape and type, no data (a ``meta`` tensor; reading it raises)."""
    return NDArray(torch.empty(t.shape, dtype=t.dtype, device="meta"))


class _CustomFunction(torch.autograd.Function):
    """Forward: the user's ``CustomOp.forward`` on NDArrays over the input
    tensors, fresh outputs (uninitialised, as the reference's; req
    "write") and the aux states (updated in place). Only the inputs and
    outputs that the prop's ``declare_backward_dependency`` names are kept
    for the backward; the others reach it as data-less NDArrays of their
    shape. Backward: the user's ``backward`` into fresh input gradients,
    req "write" for each input autograd wants a gradient of, "null" for
    the rest; the op's graph adds or overwrites into the caller's
    buffers."""

    @staticmethod
    def forward(ctx, op, deps, is_train, specs, aux, *inputs):
        ins = [NDArray(t) for t in inputs]
        outs = [NDArray(torch.empty(s, dtype=d, device=inputs[0].device))
                for s, d in specs]
        aux_nd = [NDArray(t) for t in aux]
        op.forward(is_train, ["write"] * len(outs), ins, outs, aux_nd)
        results = tuple(o._data for o in outs)
        keep_in, keep_out = deps
        ctx.op, ctx.aux, ctx.deps = op, aux, deps
        ctx.save_for_backward(*(inputs[i] for i in keep_in),
                              *(results[j] for j in keep_out))
        ctx.in_meta = [_unkept(t) for t in inputs]
        ctx.out_meta = [_unkept(t) for t in results]
        return results

    @staticmethod
    def backward(ctx, *out_grads):
        keep_in, keep_out = ctx.deps
        saved = iter(ctx.saved_tensors)
        inputs, results = list(ctx.in_meta), list(ctx.out_meta)
        for i in keep_in:
            inputs[i] = NDArray(next(saved))
        for j in keep_out:
            results[j] = NDArray(next(saved))
        needs = ctx.needs_input_grad[5:]
        in_grads = [NDArray(torch.empty(x.shape, dtype=x._data.dtype,
                                        device=out_grads[0].device))
                    for x in ctx.in_meta]
        ctx.op.backward(["write" if n else "null" for n in needs],
                        [NDArray(g) for g in out_grads], inputs, results,
                        in_grads, [NDArray(t) for t in ctx.aux])
        return (None,) * 5 + tuple(
            g._data if n else None for g, n in zip(in_grads, needs))


def apply_custom(attrs: Dict[str, Any], inputs, aux, ctx):
    """Run a Custom op on tensors; returns (outputs, aux updates).

    On the ``meta`` device (shape inference) the outputs come from the
    prop's ``infer_shape`` / ``infer_type`` and no user code runs. Else the
    operator (and its declared backward dependencies) is created once per
    ``ctx.memo`` (a bound node) and key of input shapes, types and device,
    and runs as a ``torch.autograd.Function``; the aux states are copies
    the user updates in place, which the graph writes back."""
    prop = make_prop(attrs)
    n_aux = len(prop.list_auxiliary_states())
    if len(aux) != n_aux:
        raise MXNetError("Custom(%s): expected %d aux states, got %d"
                         % (attrs.get("op_type"), n_aux, len(aux)))
    in_shapes = [tuple(x.shape) for x in inputs]
    in_dtypes = [x.dtype for x in inputs]
    specs = _output_specs(prop, in_shapes, in_dtypes)
    device = inputs[0].device
    if device.type == "meta":
        return (tuple(torch.empty(s, dtype=d, device=device)
                      for s, d in specs), tuple(aux))
    memo = ctx.memo if ctx.memo is not None else {}
    key = ("Custom", tuple(in_shapes), tuple(in_dtypes), device)
    if key not in memo:
        memo[key] = (prop.create_operator(
            device, [list(s) for s in in_shapes],
            [_np_dtype(d) for d in in_dtypes]),
            _backward_deps(prop, len(inputs), len(specs)))
    op, deps = memo[key]
    aux_copies = [a.detach().clone() for a in aux]
    outs = _CustomFunction.apply(op, deps, bool(ctx.is_train), specs,
                                 aux_copies, *inputs)
    return tuple(outs), tuple(aux_copies)


# --- legacy interface (reference NumpyOp, operator.py:28-390) -----------------
class PythonOp(CustomOp):
    """Legacy numpy op (reference ``NumpyOp``): implement
    ``forward_np(in_data, out_data)`` and ``backward_np(out_grad, in_data,
    out_data, in_grad)`` over numpy arrays, filling the output (gradient)
    arrays in place; the port copies them into the op's tensors."""

    copies_to_host = True

    def forward(self, is_train, req, in_data, out_data, aux):
        outs = [o.asnumpy() for o in out_data]
        self.forward_np([x.asnumpy() for x in in_data], outs)
        for o, r, v in zip(out_data, req, outs):
            self.assign(o, r, v)

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        grads = [g.asnumpy() for g in in_grad]
        self.backward_np([x.asnumpy() for x in out_grad],
                         [x.asnumpy() for x in in_data],
                         [x.asnumpy() for x in out_data], grads)
        for g, r, v in zip(in_grad, req, grads):
            self.assign(g, r, v)

    def forward_np(self, in_data, out_data):
        raise NotImplementedError

    def backward_np(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError
