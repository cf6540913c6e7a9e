"""The single operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py``. One :class:`OpDef` per
operator: ``impl`` is plain PyTorch on tensors (autograd differentiates it;
an op that overrides the mathematical gradient, such as ``SoftmaxOutput``,
does so with a ``torch.autograd.Function`` inside ``impl``), ``arg_names``
/ ``aux_names`` its inputs, ``param_spec`` its typed attributes with
defaults. The imperative ``ndarray`` and symbolic ``symbol`` namespaces are
generated from this registry at import.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..base import MXNetError, coerce_attr

OP_REGISTRY: Dict[str, "OpDef"] = {}

# A required parameter (no default) in a param_spec.
REQUIRED = object()


@dataclasses.dataclass
class OpContext:
    """Per-call execution context (reference OpContext, operator.h:42-62).
    ``device`` is where the graph runs (``meta`` in shape inference); None
    in an imperative call, where an op without inputs reads its ``ctx``
    attribute."""

    is_train: bool = False
    device: Optional[torch.device] = None
    # a dict that lives as long as the bound graph node the call runs
    # (one per node of Symbol.build_eval; None in an imperative call): an
    # op keeps state there across the graph's calls (the Custom op's
    # operator, created once per bound node as the reference creates it
    # at bind)
    memo: Optional[Dict[Any, Any]] = None


@dataclasses.dataclass
class OpDef:
    name: str
    # impl(attrs, inputs: tuple, aux: tuple, ctx: OpContext)
    #   -> (outputs: tuple, aux_updates: tuple)
    impl: Callable
    arg_names: Any = ("data",)  # tuple, or fn(attrs) -> tuple
    aux_names: Any = ()
    num_outputs: Any = 1  # int, or fn(attrs) -> int
    param_spec: Optional[Dict[str, Any]] = None  # name -> default / REQUIRED
    variadic: bool = False  # takes any number of inputs (add_n)
    no_grad_inputs: Sequence[str] = ()  # e.g. labels
    doc: str = ""
    py_name: Optional[str] = None  # name in the nd / sym namespaces
    output_names: Any = None  # tuple or fn(attrs); default ["output"]
    # fn(attrs, shapes) -> shapes: parameter shapes from the data shape
    # (ops/shape_rules.py); None where the op has no parameters to size
    infer_params: Optional[Callable] = None

    def get_arg_names(self, attrs) -> Tuple[str, ...]:
        a = self.arg_names
        return tuple(a(attrs) if callable(a) else a)

    def get_aux_names(self, attrs) -> Tuple[str, ...]:
        a = self.aux_names
        return tuple(a(attrs) if callable(a) else a)

    def get_num_outputs(self, attrs) -> int:
        n = self.num_outputs
        return n(attrs) if callable(n) else n

    def get_output_names(self, attrs):
        o = self.output_names
        if o is None:
            n = self.get_num_outputs(attrs)
            return ["output"] if n == 1 else ["output%d" % i
                                              for i in range(n)]
        return list(o(attrs) if callable(o) else o)

    def parse_attrs(self, kwargs: Dict[str, Any]) -> Dict[str, Any]:
        """Validate and coerce kwargs against ``param_spec``; unknown keys
        and missing required ones raise (dmlc::Parameter::Init)."""
        if self.param_spec is None:
            return {k: coerce_attr(v) for k, v in kwargs.items()}
        attrs = {}
        for key, val in kwargs.items():
            if key not in self.param_spec:
                raise MXNetError("%s got unknown parameter %r (known: %s)"
                                 % (self.name, key, sorted(self.param_spec)))
            attrs[key] = coerce_attr(val)
        for key, default in self.param_spec.items():
            if key in attrs:
                continue
            if default is REQUIRED:
                raise MXNetError("%s requires parameter %r"
                                 % (self.name, key))
            attrs[key] = default
        return attrs


def register_op(opdef: OpDef) -> OpDef:
    if opdef.name in OP_REGISTRY:
        raise MXNetError("operator %s already registered" % opdef.name)
    OP_REGISTRY[opdef.name] = opdef
    return opdef


def get_op(name: str) -> OpDef:
    try:
        return OP_REGISTRY[name]
    except KeyError:
        raise MXNetError("unknown operator %r" % name) from None


def defop(name, arg_names=("data",), aux_names=(), num_outputs=1,
          param_spec=None, variadic=False, no_grad_inputs=(), py_name=None,
          output_names=None, simple=True):
    """Decorator registering an operator implementation.

    ``simple=True``  — fn(attrs, *inputs) -> out | tuple(outs)
    ``simple=False`` — fn(attrs, inputs, aux, ctx) -> (outs, aux_updates)
    """

    def dec(fn):
        if simple:
            def impl(attrs, inputs, aux, ctx, _fn=fn):
                out = _fn(attrs, *inputs)
                return (out if isinstance(out, tuple) else (out,)), ()
        else:
            impl = fn
        register_op(OpDef(
            name=name, impl=impl, arg_names=arg_names, aux_names=aux_names,
            num_outputs=num_outputs, param_spec=param_spec,
            variadic=variadic, no_grad_inputs=no_grad_inputs,
            doc=fn.__doc__ or "", py_name=py_name or name,
            output_names=output_names))
        return fn

    return dec


def alias(opdef_name: str, *names: str):
    """Register alternative names for an op (reference add_alias)."""
    op = get_op(opdef_name)
    for n in names:
        OP_REGISTRY.setdefault(n, op)
