"""The ``Custom`` operator: the graph-side entry of Python custom ops.

Counterpart of ``mxnet_tpu/ops/custom.py`` (reference src/operator/custom/
custom.cc). ``Custom(op_type=...)`` dispatches to the user class registered
with ``mxnet_tpu_torch.operator.register``; its argument, aux and output
names come from that class's ``CustomOpProp``, and its ``infer_params``
asks the prop's ``infer_shape`` for the inputs the caller left unknown (a
label's shape from the data's), as the reference's shape inference does.
``nd.Custom`` and ``sym.Custom`` are generated from the registry.
"""
from __future__ import annotations

from .registry import OpDef, register_op


def _prop(attrs):
    from .. import operator as _operator

    return _operator.make_prop(attrs)


def _impl(attrs, inputs, aux, ctx):
    """Apply a registered Python custom operator (``op_type``)."""
    from .. import operator as _operator

    return _operator.apply_custom(attrs, inputs, aux, ctx)


def _infer(attrs, shapes):
    """The prop's ``infer_shape`` from the known input shapes (ordered
    arguments + aux states), filling only the unknown ones. Unknown input
    shapes reach the prop as ``[]``, as the reference passes an unknown
    shape."""
    prop = _prop(attrs)
    n_args = len(prop.list_arguments())
    if not shapes or shapes[0] is None:
        return shapes
    args, _, aux = prop.infer_shape([list(s) if s is not None else []
                                     for s in shapes[:n_args]])
    for i, s in enumerate(list(args) + list(aux or [])):
        if i < len(shapes) and shapes[i] is None and s is not None \
                and len(s):
            shapes[i] = tuple(int(x) for x in s)
    return shapes


register_op(OpDef(
    name="Custom",
    impl=_impl,
    arg_names=lambda attrs: tuple(_prop(attrs).list_arguments()),
    aux_names=lambda attrs: tuple(_prop(attrs).list_auxiliary_states()),
    num_outputs=lambda attrs: len(_prop(attrs).list_outputs()),
    output_names=lambda attrs: list(_prop(attrs).list_outputs()),
    param_spec=None,  # op_type + free-form kwargs for the prop constructor
    infer_params=_infer,
    doc=_impl.__doc__,
    py_name="Custom",
))
