"""Symbolic graph API.

Counterpart of ``mxnet_tpu/symbol.py`` (reference nnvm::Symbol +
python/mxnet/symbol.py). A :class:`Symbol` is a list of output entries
over a DAG of nodes; composing symbols builds the graph. ``infer_shape``
runs every operator on ``meta`` tensors (shapes and types, no data), with
the per-op parameter rules of ``ops/shape_rules.py`` sizing the weights;
``simple_bind`` allocates from it and binds an :class:`~.executor.
Executor`; :meth:`Symbol.build_eval` is a topological-order interpreter
over the op registry, run eagerly by the executor (autograd differentiates
it). Graph JSON (:meth:`Symbol.tojson`, :func:`load_json`) is the JAX
package's own schema or, with ``format="reference"``, the reference
MXNet's (``interop.py``); a file written by either package builds the
same graph in the other. An operator that draws (``Dropout``) gets the
generator of the graph's device (``random.generator``). ``Symbol.grad``
and the segmented-remat evaluator are not ported.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import attribute, name as _name_mod
from . import random as _random
from .base import MXNetError, coerce_attr
from .ndarray import _as_torch_dtype
from .ops import OP_REGISTRY, OpContext, OpDef, get_op


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "is_aux", "misc_attrs")

    def __init__(self, op: Optional[OpDef], name: str, attrs: Dict[str, Any],
                 inputs: List[Tuple["_Node", int]], is_aux: bool = False,
                 misc_attrs: Optional[Dict[str, str]] = None):
        self.op = op
        self.name = name
        self.attrs = attrs
        self.inputs = inputs
        self.is_aux = is_aux  # variable node holding auxiliary state
        self.misc_attrs = misc_attrs or {}

    @property
    def is_var(self):
        return self.op is None

    def split_inputs(self, values):
        """(args, aux) of this op node's input ``values``."""
        n_aux = 0 if self.op.variadic else len(self.op.get_aux_names(
            self.attrs))
        n_args = len(values) - n_aux
        return tuple(values[:n_args]), tuple(values[n_args:])


def _topo_order(out_entries) -> List[_Node]:
    order: List[_Node] = []
    visited = set()

    def visit(node):
        if id(node) in visited:
            return
        visited.add(id(node))
        for child, _ in node.inputs:
            visit(child)
        order.append(node)

    for node, _ in out_entries:
        visit(node)
    return order


class Symbol:
    def __init__(self, entries: List[Tuple[_Node, int]]):
        self._entries = list(entries)

    # --- introspection ----------------------------------------------------
    @property
    def name(self):
        if len(self._entries) == 1:
            return self._entries[0][0].name
        return None

    def _nodes(self) -> List[_Node]:
        return _topo_order(self._entries)

    def list_arguments(self) -> List[str]:
        return [n.name for n in self._nodes() if n.is_var and not n.is_aux]

    def list_auxiliary_states(self) -> List[str]:
        return [n.name for n in self._nodes() if n.is_var and n.is_aux]

    def list_outputs(self) -> List[str]:
        outs = []
        for node, idx in self._entries:
            if node.is_var:
                outs.append(node.name)
            else:
                onames = node.op.get_output_names(node.attrs)
                outs.append("%s_%s" % (node.name, onames[idx]))
        return outs

    def list_inputs(self):
        return [n.name for n in self._nodes() if n.is_var]

    def _needs_rng(self):
        """Whether an operator of the graph draws random numbers."""
        return any(not n.is_var and n.op.needs_rng for n in self._nodes())

    def get_internals(self) -> "Symbol":
        entries = []
        for node in self._nodes():
            n_out = 1 if node.is_var else node.op.get_num_outputs(node.attrs)
            entries.extend((node, i) for i in range(n_out))
        return Symbol(entries)

    def __getitem__(self, index):
        if isinstance(index, str):
            outs = self.list_outputs()
            if index not in outs:
                raise MXNetError("cannot find output %r in %s"
                                 % (index, outs))
            index = outs.index(index)
        return Symbol([self._entries[index]])

    def __len__(self):
        return len(self._entries)

    def __iter__(self):
        return (self[i] for i in range(len(self._entries)))

    def attr(self, key):
        if len(self._entries) == 1:
            return self._entries[0][0].misc_attrs.get(key)
        return None

    def attr_dict(self):
        return {node.name: dict(node.misc_attrs) for node in self._nodes()
                if node.misc_attrs}

    def _set_attr(self, **kwargs):
        for node, _ in self._entries:
            node.misc_attrs.update(kwargs)

    # --- composition ------------------------------------------------------
    def __call__(self, *args, **kwargs):
        """Compose: substitute variable nodes (reference Symbol compose)."""
        s = self.__copy__()
        s._compose(*args, **kwargs)
        return s

    def _compose(self, *args, **kwargs):
        mapping = {}
        if args:
            vars_in = [n for n in self._nodes() if n.is_var and not n.is_aux]
            for var, rep in zip(vars_in, args):
                mapping[id(var)] = rep._entries[0]
        for k, v in kwargs.items():
            for n in self._nodes():
                if n.is_var and n.name == k:
                    mapping[id(n)] = v._entries[0]
        for node in self._nodes():
            node.inputs = [mapping.get(id(child), (child, idx))
                           if child.is_var else (child, idx)
                           for child, idx in node.inputs]

    def __copy__(self):
        memo: Dict[int, _Node] = {}

        def cp(node):
            if id(node) in memo:
                return memo[id(node)]
            nn = _Node(node.op, node.name, dict(node.attrs), [], node.is_aux,
                       dict(node.misc_attrs))
            memo[id(node)] = nn
            nn.inputs = [(cp(c), i) for c, i in node.inputs]
            return nn

        return Symbol([(cp(n), i) for n, i in self._entries])

    # --- arithmetic (creates broadcast graph nodes) -----------------------
    def _binop(self, other, op_name, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _create_symbol(get_op(op_name), [a, b], {}, None)
        name = scalar_op.replace("_", "_r", 1) if reverse else scalar_op
        return _create_symbol(get_op(name), [self], {"scalar": float(other)},
                              None)

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

    def __pow__(self, other):
        return self._binop(other, "broadcast_power", "_power_scalar")

    def __neg__(self):
        return self._binop(-1.0, "broadcast_mul", "_mul_scalar")

    # --- inference --------------------------------------------------------
    def infer_shape(self, **kwargs):
        """(arg shapes, output shapes, aux shapes) from the named input
        shapes; raises if any stays unknown."""
        return self._infer(kwargs, {}, partial=False)[:3]

    def infer_shape_partial(self, **kwargs):
        """As :meth:`infer_shape`, with None where a shape stays unknown."""
        return self._infer(kwargs, {}, partial=True)[:3]

    def _infer(self, known_shapes, known_dtypes, partial):
        """Propagate meta tensors (shape + dtype) through the graph; returns
        (arg shapes, out shapes, aux shapes, {variable name: torch dtype})."""
        known_shapes = {k: tuple(v) for k, v in known_shapes.items()
                        if v is not None}
        env: Dict[Tuple[int, int], torch.Tensor] = {}
        var_meta: Dict[str, torch.Tensor] = {}
        nodes = self._nodes()

        def meta(shape, dtype):
            return torch.empty(tuple(shape), dtype=dtype, device="meta")

        for node in nodes:
            if not node.is_var:
                continue
            shape = known_shapes.get(node.name)
            if shape is None and "__shape__" in node.misc_attrs:
                shape = tuple(json.loads(node.misc_attrs["__shape__"]))
            dtype = known_dtypes.get(node.name)
            if dtype is None and "__dtype__" in node.misc_attrs:
                dtype = node.misc_attrs["__dtype__"]
            if shape is not None:
                t = meta(shape, _as_torch_dtype(dtype))
                env[(id(node), 0)] = var_meta[node.name] = t

        for node in nodes:
            if node.is_var:
                continue
            op, attrs = node.op, node.attrs
            ins = [env.get((id(c), i)) for c, i in node.inputs]
            if op.infer_params is not None:
                shapes = op.infer_params(
                    attrs, [None if t is None else tuple(t.shape)
                            for t in ins])
                ref = next((t.dtype for t in ins if t is not None),
                           torch.float32)
                for (child, cidx), t, s in zip(node.inputs, ins, shapes):
                    if t is None and s is not None:
                        env[(id(child), cidx)] = m = meta(s, ref)
                        if child.is_var:
                            var_meta[child.name] = m
                ins = [env.get((id(c), i)) for c, i in node.inputs]
            if any(t is None for t in ins):
                if partial:
                    continue
                missing = [node.inputs[i][0].name
                           for i, t in enumerate(ins) if t is None]
                raise MXNetError("infer_shape: cannot infer inputs %s of "
                                 "node %s; provide their shapes"
                                 % (missing, node.name))
            args, aux = node.split_inputs(ins)
            try:
                with torch.no_grad():
                    outs, _ = op.impl(attrs, args, aux, OpContext(
                        False, torch.device("meta")))
            except Exception as e:  # surface with the node's context
                raise MXNetError("shape inference failed at node %s (%s): %s"
                                 % (node.name, op.name, e)) from e
            for i, o in enumerate(outs):
                env[(id(node), i)] = o

        def shapes_of(names):
            return [tuple(var_meta[n].shape) if n in var_meta else None
                    for n in names]

        args_s = shapes_of(self.list_arguments())
        aux_s = shapes_of(self.list_auxiliary_states())
        outs_s = [tuple(env[(id(n), i)].shape) if (id(n), i) in env
                  else None for n, i in self._entries]
        if not partial and any(s is None for s in args_s + outs_s + aux_s):
            raise MXNetError("infer_shape: incomplete inference; missing "
                             "shapes")
        return args_s, outs_s, aux_s, {n: t.dtype
                                       for n, t in var_meta.items()}

    # --- binding ----------------------------------------------------------
    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, compute_dtype=None):
        """An :class:`~.executor.Executor` over the given arrays;
        ``compute_dtype`` ("bfloat16") runs the graph in that type over
        f32 values (default ``MXNET_COMPUTE_DTYPE``)."""
        from .executor import Executor

        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        compute_dtype=compute_dtype)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    compute_dtype=None, **kwargs):
        """Infer shapes from the named input shapes, allocate zeroed
        arguments (and gradients, for every argument whose ``grad_req`` is
        not "null") on ``ctx``, and bind (``compute_dtype`` as in
        :meth:`bind`). ``ctx`` None is the first CUDA card; without one it
        raises."""
        from . import ndarray as nd
        from .context import resolve_device
        from .executor import Executor

        device = resolve_device(ctx)
        arg_shapes, _, aux_shapes, dtypes = self._infer(
            kwargs, dict(type_dict or {}), partial=False)
        arg_names = self.list_arguments()
        reqs = _grad_reqs(grad_req, arg_names)
        args = {n: nd.zeros(s, device, dtypes[n])
                for n, s in zip(arg_names, arg_shapes)}
        grads = {n: nd.zeros(a.shape, device, dtypes[n])
                 for n, a in args.items() if reqs[n] != "null"}
        aux = {n: nd.zeros(s, device, dtypes[n])
               for n, s in zip(self.list_auxiliary_states(), aux_shapes)}
        return Executor(self, device, args, grads, reqs, aux,
                        compute_dtype=compute_dtype)

    # --- evaluation -------------------------------------------------------
    def build_eval(self):
        """fn(arg_values, aux_values, is_train) -> (outputs, aux_updates):
        runs the graph's operators in topological order on the given
        tensors. Differentiable with autograd when called with grad
        enabled."""
        nodes = self._nodes()
        entries = self._entries
        # per-node state that lives as long as this evaluator (OpContext.memo)
        memos = {id(node): {} for node in nodes if not node.is_var}

        def eval_fn(arg_values, aux_values, is_train):
            env: Dict[Tuple[int, int], Any] = {}
            aux_updates: Dict[str, Any] = {}
            first = next(iter(arg_values.values()), None)
            device = None if first is None else first.device
            for node in nodes:
                if node.is_var:
                    src = aux_values if node.is_aux else arg_values
                    if node.name not in src:
                        raise MXNetError("missing value for %s" % node.name)
                    env[(id(node), 0)] = src[node.name]
                    continue
                args, aux = node.split_inputs(
                    [env[(id(c), i)] for c, i in node.inputs])
                rng = (_random.generator(device)
                       if node.op.needs_rng and device is not None else None)
                outs, aux_out = node.op.impl(
                    node.attrs, args, aux,
                    OpContext(is_train, device, memos[id(node)], rng))
                for i, o in enumerate(outs):
                    env[(id(node), i)] = o
                n_args = len(args)
                for (child, _), new in zip(node.inputs[n_args:], aux_out):
                    if child.is_var:
                        aux_updates[child.name] = new
            return [env[(id(n), i)] for n, i in entries], aux_updates

        eval_fn.memos = memos
        return eval_fn

    # --- save / load ------------------------------------------------------
    def tojson(self, format: str = "native") -> str:
        """The graph as JSON: ``native``, the JAX package's schema (node
        attributes as ``repr`` strings, ``attrs.mxnet_tpu_version``), or
        ``reference``, the reference MXNet's ``nodes`` / ``arg_nodes`` /
        ``heads`` schema (``interop.save_symbol_json``)."""
        if format == "reference":
            from . import interop

            return interop.save_symbol_json(self)
        if format != "native":
            raise ValueError("unknown symbol JSON format %r" % (format,))
        nodes = self._nodes()
        idx = {id(n): i for i, n in enumerate(nodes)}
        jnodes = [{
            "op": "null" if n.is_var else n.op.name,
            "name": n.name,
            # None as "null", which coerce_attr reads back as None
            "attrs": {k: ("null" if v is None else repr(v)
                          if not isinstance(v, str) else v)
                      for k, v in n.attrs.items()},
            "inputs": [[idx[id(c)], i, 0] for c, i in n.inputs],
            "is_aux": bool(n.is_aux),
            "misc_attrs": n.misc_attrs} for n in nodes]
        return json.dumps({
            "nodes": jnodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_var],
            "heads": [[idx[id(n)], i, 0] for n, i in self._entries],
            "attrs": {"mxnet_tpu_version": 1}}, indent=2)

    def save(self, fname: str, format: str = "native"):
        with open(fname, "w") as f:
            f.write(self.tojson(format=format))

    def debug_str(self):
        lines = []
        for n in self._nodes():
            if n.is_var:
                lines.append("Variable:%s" % n.name)
            else:
                ins = ", ".join("%s[%d]" % (c.name, i) for c, i in n.inputs)
                lines.append("%s(%s) name=%s attrs=%s"
                             % (n.op.name, ins, n.name, n.attrs))
        return "\n".join(lines)


def _grad_reqs(grad_req, arg_names):
    """Per-argument grad_req from a string, a list or a dict (missing
    names in a dict are "null")."""
    if isinstance(grad_req, str):
        return {n: grad_req for n in arg_names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(arg_names, grad_req))
    return {n: grad_req.get(n, "null") for n in arg_names}


def load_json(json_str: str) -> Symbol:
    """A Symbol from JSON in either schema of :meth:`Symbol.tojson` (the
    reference's, of any version its legacy upgrader reads, through
    ``interop.load_symbol_json``)."""
    from . import interop

    data = json.loads(json_str)
    if interop.is_reference_symbol_json(data):
        return interop.load_symbol_json(data)
    nodes: List[_Node] = []
    for jn in data["nodes"]:
        if jn["op"] == "null":
            node = _Node(None, jn["name"], {}, [], jn.get("is_aux", False),
                         jn.get("misc_attrs", {}))
        else:
            op = get_op(jn["op"])
            attrs = op.parse_attrs({k: coerce_attr(v) for k, v in
                                    jn.get("attrs", {}).items()})
            inputs = [(nodes[i], oi) for i, oi, _ in jn["inputs"]]
            node = _Node(op, jn["name"], attrs, inputs, False,
                         jn.get("misc_attrs", {}))
        nodes.append(node)
    return Symbol([(nodes[i], oi) for i, oi, _ in data["heads"]])


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


def Variable(name: str, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, **kwargs) -> Symbol:
    """A variable symbol (reference symbol.py Variable). ``init`` (an
    initializer or its JSON) becomes the ``__init__`` attribute, which
    ``Module.init_params`` hands the initializer."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    misc = attribute.current().get(attr or {})
    if shape is not None:
        misc["__shape__"] = json.dumps(list(shape))
    if dtype is not None:
        misc["__dtype__"] = str(np.dtype(dtype))
    if lr_mult is not None:
        misc["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        misc["__wd_mult__"] = str(wd_mult)
    if init is not None:
        misc["__init__"] = init if isinstance(init, str) else init.dumps()
    for k, v in kwargs.items():
        misc[k] = str(v)
    return Symbol([(_Node(None, name, {}, [], False, misc), 0)])


var = Variable


def zeros(shape, dtype="float32", **kwargs) -> Symbol:
    """A symbol of zeros (the ``_zeros`` op), made on the device of the
    graph that runs it."""
    return _create_symbol(get_op("_zeros"), [], {"shape": shape,
                                                  "dtype": dtype},
                          kwargs.get("name"))


def ones(shape, dtype="float32", **kwargs) -> Symbol:
    """A symbol of ones (the ``_ones`` op)."""
    return _create_symbol(get_op("_ones"), [], {"shape": shape,
                                                 "dtype": dtype},
                          kwargs.get("name"))


def Group(symbols: Sequence[Symbol]) -> Symbol:
    entries = []
    for s in symbols:
        entries.extend(s._entries)
    return Symbol(entries)


def _create_symbol(op: OpDef, input_syms: List[Optional[Symbol]],
                   attrs: Dict[str, Any], name: Optional[str],
                   input_names: Optional[List[str]] = None) -> Symbol:
    parsed = op.parse_attrs(attrs)
    hint = (op.py_name or op.name).lower().lstrip("_")
    node_name = _name_mod.current().get(name, hint)
    arg_names = list(op.get_arg_names(parsed))
    aux_names = list(op.get_aux_names(parsed))
    entries: List[Tuple[_Node, int]] = []
    if op.variadic:
        entries = [s._entries[0] for s in input_syms]
    else:
        given = dict(zip(input_names or (arg_names + aux_names), input_syms))
        for n in arg_names + aux_names:
            if given.get(n) is not None:
                entries.append(given[n]._entries[0])
            else:
                # a missing input becomes the variable <node>_<input>
                # (reference: NNVM compose)
                vnode = _Node(None, "%s_%s" % (node_name, n), {}, [],
                              is_aux=(n in aux_names),
                              misc_attrs=attribute.current().get({}))
                entries.append((vnode, 0))
    node = _Node(op, node_name, parsed, entries, False,
                 attribute.current().get({}))
    return Symbol([(node, i) for i in range(op.get_num_outputs(parsed))])


def _make_sym_function(op: OpDef):
    def fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        sym_kwargs, attrs = {}, {}
        for k, v in kwargs.items():
            (sym_kwargs if isinstance(v, Symbol) else attrs)[k] = v
        if op.variadic:
            inputs = list(args) + [sym_kwargs[k] for k in sorted(sym_kwargs)]
            s = _create_symbol(op, inputs, attrs, name)
        else:
            parsed = op.parse_attrs(attrs)
            names = (list(op.get_arg_names(parsed))
                     + list(op.get_aux_names(parsed)))
            ordered: List[Optional[Symbol]] = [None] * len(names)
            for i, a in enumerate(args):
                ordered[i] = a
            for k, v in sym_kwargs.items():
                if k not in names:
                    raise MXNetError("%s: unexpected input %r" % (op.name, k))
                ordered[names.index(k)] = v
            s = _create_symbol(op, ordered, attrs, name, input_names=names)
        if attr:
            s._set_attr(**attr)
        return s

    fn.__name__ = op.py_name or op.name
    fn.__doc__ = op.doc
    return fn


def _populate_namespace():
    g = globals()
    made = {}
    for rname, op in OP_REGISTRY.items():
        if id(op) not in made:
            made[id(op)] = _make_sym_function(op)
        g.setdefault(rname, made[id(op)])
        g.setdefault(op.py_name or rname, made[id(op)])


_populate_namespace()
