"""Graph executor.

Counterpart of ``mxnet_tpu/executor.py`` (reference src/executor/
graph_executor.cc, include/mxnet/executor.h:34-104). The bound graph runs
eagerly through :meth:`Symbol.build_eval`:

- ``forward(is_train=True)`` runs it with autograd recording, from
  gradient-requiring views of the arguments, and keeps the graph;
- ``backward(out_grads)`` differentiates that graph (head gradients of
  ones by default) and lands each gradient in its ``grad_dict`` tensor:
  ``write`` overwrites, ``add`` accumulates, ``null`` skips. A
  ``backward()`` with no training forward before it runs one itself, as
  the reference's fused forward+backward does.

Arguments, gradients and aux states live in NDArrays on one device; the
executor writes into their tensors in place.

``compute_dtype`` ("bfloat16"; default ``MXNET_COMPUTE_DTYPE``) runs the
graph in that type over f32 master values, as the reference does: f32
arguments and aux states are cast on the way in, outputs and aux updates
come back f32, and the gradients land in f32 (autograd through the cast).
One deliberate divergence: an argument that feeds only index or label
slots (``Embedding``'s ids, ``one_hot``'s indices, ``SoftmaxOutput``'s
label, through shape ops) is not cast, because bf16 holds integers
exactly only up to 256; the reference casts them.

:meth:`Executor.make_train_step` is the whole training step (forward,
backward and the caller's update) as one function; on the card it is one
CUDA graph, captured after a few warm-up calls and replayed (``_TrainStep``).
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device
from .ndarray import NDArray, _as_torch_dtype
from .ops.kernels import _launches
from .symbol import _grad_reqs

# eager calls of a captured train step before its capture
CAPTURE_WARMUP = 2

# ops that only move or view their input: an index or label that passes
# through them is still one
_SHAPE_OPS = frozenset({"Reshape", "Flatten", "expand_dims", "SwapAxis",
                        "slice_axis", "identity", "BlockGrad"})


def _compute_dtype(compute_dtype):
    """The torch type of a ``compute_dtype`` argument (None reads
    ``MXNET_COMPUTE_DTYPE``); None for f32 compute."""
    if compute_dtype is None:
        compute_dtype = os.environ.get("MXNET_COMPUTE_DTYPE") or None
    if compute_dtype in (None, "", "float32") or \
            compute_dtype == torch.float32:
        return None
    return _as_torch_dtype(compute_dtype)


def _index_only_args(symbol):
    """Names of the arguments every use of which is an index or label slot
    (an op's ``no_grad_inputs``), directly or through :data:`_SHAPE_OPS`;
    an argument that is also a graph output is not."""
    nodes = symbol._nodes()
    uses = {id(n): [] for n in nodes}
    for node in nodes:
        if node.is_var:
            continue
        names = () if node.op.variadic else node.op.get_arg_names(
            node.attrs)
        for pos, (child, _) in enumerate(node.inputs):
            slot = names[pos] if pos < len(names) else None
            uses[id(child)].append((node, slot))
    outputs = {id(n) for n, _ in symbol._entries}
    memo = {}

    def only_index(node):
        if id(node) not in memo:
            memo[id(node)] = id(node) not in outputs and bool(
                uses[id(node)]) and all(
                    slot in user.op.no_grad_inputs
                    or (user.op.name in _SHAPE_OPS and only_index(user))
                    for user, slot in uses[id(node)])
        return memo[id(node)]

    return {n.name for n in nodes
            if n.is_var and not n.is_aux and only_index(n)}


def _cast(values, dtype, src, skip=()):
    """``values`` (a dict) with the tensors of type ``src`` cast to
    ``dtype``, but for the names in ``skip``."""
    return {n: (v.to(dtype) if n not in skip and v.dtype == src else v)
            for n, v in values.items()}


def _to_dict(values, names, what, allow_missing=False) -> Dict[str, NDArray]:
    if values is None:
        values = {}
    if isinstance(values, dict):
        out = dict(values)
    else:
        values = list(values)
        if len(values) != len(names) and not allow_missing:
            raise MXNetError("%s: expected %d entries, got %d"
                             % (what, len(names), len(values)))
        out = {n: v for n, v in zip(names, values) if v is not None}
    missing = [n for n in names if n not in out]
    if missing and not allow_missing:
        raise MXNetError("%s missing entries for %s" % (what, missing))
    return {n: v if isinstance(v, NDArray) else NDArray(v)
            for n, v in out.items()}


class Executor:
    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, compute_dtype=None):
        self._symbol = symbol
        self._compute_dtype = _compute_dtype(compute_dtype)
        self._device = resolve_device(ctx)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        self.arg_dict = _to_dict(args, arg_names, "args")
        self.aux_dict = _to_dict(aux_states, aux_names, "aux")
        self.grad_dict = _to_dict(args_grad, arg_names, "args_grad",
                                  allow_missing=True)
        self.grad_req = _grad_reqs(grad_req, arg_names)
        for n in arg_names:
            if n not in self.grad_dict:
                self.grad_req[n] = "null"
        for what, d in (("args", self.arg_dict), ("aux", self.aux_dict),
                        ("args_grad", self.grad_dict)):
            for n, a in d.items():
                if a.context != self._device:
                    raise MXNetError(
                        "%s %s lies on %s, the executor on %s"
                        % (what, n, a.context, self._device))
        self._arg_names = arg_names
        self._aux_names = aux_names
        self._eval_fn = symbol.build_eval()
        self._index_only = (_index_only_args(symbol)
                            if self._compute_dtype is not None else set())
        self.outputs: List[NDArray] = []
        # (gradient-requiring argument views, graph outputs) of the last
        # training forward, consumed by backward()
        self._pending = None

    @property
    def compute_dtype(self):
        """The graph's compute type (a torch dtype), or None for f32."""
        return self._compute_dtype

    def _host_copy_ops(self):
        """The Custom operators created so far whose ``copies_to_host`` is
        set (a ``NumpyOp``): they read their arrays on the host."""
        from .operator import CustomOp

        return [v[0] for memo in self._eval_fn.memos.values()
                for v in memo.values()
                if isinstance(v, tuple) and v and isinstance(v[0], CustomOp)
                and v[0].copies_to_host]

    def _run_graph(self, values, aux_values, is_train):
        """The graph on ``values`` in the compute type: f32 in, f32 out."""
        cd = self._compute_dtype
        if cd is None:
            return self._eval_fn(values, aux_values, is_train)
        f32 = torch.float32
        outs, aux_up = self._eval_fn(
            _cast(values, cd, f32, self._index_only),
            _cast(aux_values, cd, f32), is_train)
        return ([o.to(f32) if o.dtype == cd else o for o in outs],
                _cast(aux_up, f32, cd))

    # --- public API (reference Executor::Forward/Backward) ----------------
    def forward(self, is_train=False, **kwargs):
        """Run the graph; keyword arrays are copied into ``arg_dict``
        first. ``is_train`` keeps the autograd graph for :meth:`backward`
        and writes aux-state updates back."""
        for k, v in kwargs.items():
            if k in self.arg_dict:
                self.arg_dict[k][:] = v
        self._pending = None
        aux_values = {n: a._data for n, a in self.aux_dict.items()}
        if is_train:
            leaves = {n: a._data.detach().requires_grad_()
                      for n, a in self.arg_dict.items()
                      if self.grad_req[n] != "null"}
            values = {n: leaves.get(n, a._data)
                      for n, a in self.arg_dict.items()}
            with torch.enable_grad():
                outs, aux_up = self._run_graph(values, aux_values, True)
            self._pending = (leaves, outs)
            with torch.no_grad():
                for n, v in aux_up.items():
                    self.aux_dict[n]._data.copy_(v)
        else:
            values = {n: a._data for n, a in self.arg_dict.items()}
            with torch.no_grad():
                outs, _ = self._run_graph(values, aux_values, False)
        self.outputs = [NDArray(o.detach()) for o in outs]
        return self.outputs

    def backward(self, out_grads=None):
        """Gradients of the last training forward's outputs (weighted by
        ``out_grads``, ones by default) into ``grad_dict``."""
        if self._pending is None:
            self.forward(is_train=True)
        leaves, outs = self._pending
        self._pending = None
        if out_grads is None:
            heads = [torch.ones_like(o) for o in outs]
        else:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            heads = [g._data if isinstance(g, NDArray) else g
                     for g in out_grads]
        pairs = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
        names = list(leaves)
        grads = [None] * len(names)
        if pairs and names:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [leaves[n] for n in names],
                [h for _, h in pairs], allow_unused=True)
        with torch.no_grad():
            for n, g in zip(names, grads):
                buf = self.grad_dict[n]._data
                if self.grad_req[n] == "add":
                    if g is not None:
                        buf.add_(g)
                elif g is None:
                    buf.zero_()
                else:
                    buf.copy_(g)
        return self.outputs

    def forward_backward(self, out_grads=None, **kwargs):
        """One training step's forward and backward."""
        self.forward(is_train=True, **kwargs)
        return self.backward(out_grads)

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy numpy arrays or NDArrays (the JAX package's checkpoint
        names) into the bound arguments / aux states on this device."""
        for params, target, what in ((arg_params, self.arg_dict, "argument"),
                                     (aux_params, self.aux_dict,
                                      "aux state")):
            for n, v in (params or {}).items():
                if n not in target:
                    if allow_extra_params:
                        continue
                    raise MXNetError("unknown %s %s" % (what, n))
                src = v._data if isinstance(v, NDArray) else \
                    torch.as_tensor(np.asarray(v))
                with torch.no_grad():
                    target[n]._data.copy_(src)

    def print_summary(self):
        return self._symbol.debug_str()

    def make_train_step(self, update_fn, chain=1, mesh=None,
                        shard_axis="data"):
        """The whole training step as one function (reference
        ``Executor.make_train_step``): forward, backward and
        ``update_fn(params, grads, states, *extra) -> (new_params,
        new_states)``, a function on tensors (for example built from
        ``optimizer.pure_rule()``).

        Returns ``step(params, states, data_values, *extra) -> (outputs,
        new_params, new_states)``. ``params`` (name -> tensor or NDArray)
        covers the arguments with a gradient; ``data_values`` (name ->
        array) is copied into the bound data / label arrays first, the
        others keep theirs; ``states`` is any tree of dicts, lists and
        tuples over tensors (or None); ``extra`` is passed on to
        ``update_fn`` (the per-parameter lr / wd arrays, for example).
        ``chain`` > 1 runs that many sub-steps on the same feed; the
        outputs are the last one's. Aux states (BatchNorm's moving
        statistics) are updated in place in ``aux_dict``.

        The step owns its buffers: the first call adopts the given
        ``params`` and ``states`` tensors and the step updates them in
        place (a value ``update_fn`` returns is copied in); a later call
        with other tensors copies their values in. ``new_params`` and
        ``new_states`` are those buffers; pass them back. The outputs are
        the caller's own copies.

        On a CUDA device the step is one CUDA graph:
        ``CAPTURE_WARMUP`` eager calls on a side stream, then a capture,
        then a replay per call; data and tensor ``extra`` values are
        copied into the graph's static buffers first, other ``extra`` values and every
        shape are part of what was captured, and a change captures anew.
        A step that cannot be captured raises. On the CPU, or with
        ``MXNET_CUDA_GRAPH=0`` in the environment when the step is made,
        the same step runs eagerly."""
        if mesh is not None and _mesh_size(mesh) > 1:
            raise MXNetError("make_train_step over a mesh of %d devices is "
                             "not ported (one device)" % _mesh_size(mesh))
        del shard_axis  # one device: nothing to shard
        return _TrainStep(self, update_fn, max(1, int(chain)))


def _mesh_size(mesh):
    size = getattr(mesh, "size", None)
    return int(size) if size is not None else len(mesh)


def _tensor(v):
    return v._data if isinstance(v, NDArray) else v


def _flatten(tree):
    """(tensor leaves, structure) of a tree of dicts, lists and tuples over
    tensors, NDArrays and None; :func:`_unflatten` inverts it."""
    if isinstance(tree, dict):
        parts = [_flatten(tree[k]) for k in tree]
        return ([x for p in parts for x in p[0]],
                ("dict", tuple(tree), tuple(p[1] for p in parts)))
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(x) for x in tree]
        return ([x for p in parts for x in p[0]],
                (type(tree).__name__, len(tree),
                 tuple(p[1] for p in parts)))
    if tree is None:
        return [], None
    t = _tensor(tree)
    if not isinstance(t, torch.Tensor):
        raise MXNetError("train step: a state leaf must be a tensor, an "
                         "NDArray or None, not %s" % type(tree).__name__)
    return [t], "leaf"


def _unflatten(leaves, struct):
    it = iter(leaves)

    def build(st):
        if st is None:
            return None
        if st == "leaf":
            return next(it)
        kind = st[0]
        if kind == "dict":
            return {k: build(sub) for k, sub in zip(st[1], st[2])}
        items = [build(sub) for sub in st[2]]
        return items if kind == "list" else tuple(items)

    return build(struct)


def _same_buffer(a, b):
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride() and a.dtype == b.dtype)


class _TrainStep:
    """What :meth:`Executor.make_train_step` returns. ``stats()`` says
    which path ran: ``captured`` (with the warm-up calls, the captures and
    the replays) or ``eager``."""

    def __init__(self, exe, update_fn, chain):
        self._exe = exe
        self._update_fn = update_fn
        self._chain = chain
        self._grad_names = [n for n in exe._arg_names
                            if exe.grad_req[n] != "null"]
        self._data_names = [n for n in exe._arg_names
                            if n not in set(self._grad_names)]
        self._use_graph = exe._device.type == "cuda" and \
            os.environ.get("MXNET_CUDA_GRAPH", "1") != "0"
        self._params = None      # name -> owned tensor
        self._states = None      # (owned leaves, structure)
        self._extra = None       # owned tensor per tensor extra, else None
        self._adopted = 0        # bumped when params / states are adopted
        self._key = None
        self._graph = None
        self._graph_outs = None
        self._delta = None
        self._calls = 0          # calls at the current key
        self.warmup_calls = 0
        self.captures = 0
        self.replays = 0
        self.eager_calls = 0

    def stats(self):
        return {"path": "captured" if self._use_graph else "eager",
                "warmup_calls": self.warmup_calls,
                "captures": self.captures, "replays": self.replays,
                "eager_calls": self.eager_calls}

    # --- the buffers the step owns ----------------------------------------
    def _own(self, params, states, extra):
        missing = [n for n in self._grad_names if n not in params]
        if missing:
            raise MXNetError("train step: params lack %s" % missing)
        given = {n: _tensor(params[n]) for n in self._grad_names}
        leaves, struct = _flatten(states)
        if self._params is None:
            self._params = given
            self._adopted += 1
        else:
            for n, t in given.items():
                if not _same_buffer(t, self._params[n]):
                    self._params[n].copy_(t)
        if self._states is None or self._states[1] != struct:
            self._states = (leaves, struct)
            self._adopted += 1
        else:
            for own, t in zip(self._states[0], leaves):
                if not _same_buffer(t, own):
                    own.copy_(t)
        if self._extra is None or len(self._extra) != len(extra):
            self._extra = [None] * len(extra)
        values = []
        for i, v in enumerate(extra):
            v = _tensor(v)
            if isinstance(v, torch.Tensor):
                own = self._extra[i]
                if own is None or own.shape != v.shape or \
                        own.dtype != v.dtype or own.device != v.device:
                    own = self._extra[i] = v.detach().clone()
                elif not _same_buffer(v, own):
                    own.copy_(v)
                values.append(own)
            else:
                self._extra[i] = None
                values.append(v)
        return values

    def _key_of(self, extra):
        """What a capture fixes: the adopted parameters and states, the
        address, shape and type of every executor array and tensor
        ``extra``, and the other ``extra`` values."""
        exe = self._exe

        def sig(t):
            return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)

        return (self._adopted,
                tuple(sig(a._data) for n, a in exe.arg_dict.items()
                      if n not in self._params),
                tuple(sig(a._data) for a in exe.aux_dict.values()),
                tuple(sig(v) if isinstance(v, torch.Tensor) else ("v", v)
                      for v in extra))

    # --- the step -----------------------------------------------------------
    def _one_step(self, extra):
        exe = self._exe
        params = self._params
        leaves = {n: params[n].detach().requires_grad_()
                  for n in self._grad_names}
        values = {n: a._data for n, a in exe.arg_dict.items()}
        values.update(leaves)
        aux_values = {n: a._data for n, a in exe.aux_dict.items()}
        with torch.enable_grad():
            outs, aux_up = exe._run_graph(values, aux_values, True)
        heads = [o for o in outs if o.requires_grad]
        names = list(leaves)
        grads = [None] * len(names)
        if heads and names:
            grads = torch.autograd.grad(
                heads, [leaves[n] for n in names],
                [torch.ones_like(o) for o in heads], allow_unused=True)
        with torch.no_grad():
            # contiguous, as the executor's gradient buffers are (a
            # permuted kernel result reaches here as a view)
            grads = {n: torch.zeros_like(params[n]) if g is None
                     else g.contiguous() for n, g in zip(names, grads)}
            for n, v in aux_up.items():
                exe.aux_dict[n]._data.copy_(v)
            states = _unflatten(self._states[0], self._states[1])
            new_p, new_s = self._update_fn(dict(params), grads, states,
                                           *extra)
            for n in self._grad_names:
                if not _same_buffer(_tensor(new_p[n]), params[n]):
                    params[n].copy_(_tensor(new_p[n]))
            new_leaves, struct = _flatten(new_s)
            if struct != self._states[1]:
                raise MXNetError("train step: update_fn changed the "
                                 "states' structure")
            for own, t in zip(self._states[0], new_leaves):
                if not _same_buffer(t, own):
                    own.copy_(t)
        return [o.detach() for o in outs]

    def _body(self, extra):
        outs = None
        for _ in range(self._chain):
            outs = self._one_step(extra)
        return outs

    def _run_captured(self, extra):
        device = self._exe._device
        main = torch.cuda.current_stream(device)
        if self._calls < CAPTURE_WARMUP:
            # warm-up: real steps, on a side stream (lazy initialization,
            # compiles, cuBLAS workspaces happen outside the capture)
            side = torch.cuda.Stream(device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                outs = self._body(extra)
            main.wait_stream(side)
            for o in outs:
                o.record_stream(main)
            self.warmup_calls += 1
            return outs
        if self._graph is None:
            graph = torch.cuda.CUDAGraph()

            def record():
                with torch.cuda.graph(graph):
                    self._graph_outs = self._body(extra)

            try:
                self._delta = _launches.capture(record)
            except Exception as e:
                self._graph = self._graph_outs = None
                raise MXNetError("the training step could not be captured "
                                 "as a CUDA graph: %s" % e) from e
            self._graph = graph
            self.captures += 1
        self._graph.replay()
        _launches.replayed(self._delta)
        self.replays += 1
        return [o.clone() for o in self._graph_outs]

    def __call__(self, params, states, data_values=None, *extra):
        exe = self._exe
        for n, v in (data_values or {}).items():
            if n not in self._data_names:
                raise MXNetError("train step: %r is not a data or label "
                                 "argument of the graph" % n)
            exe.arg_dict[n][:] = v
        extra = self._own(params, states, extra)
        if self._use_graph:
            key = self._key_of(extra)
            if key != self._key:
                # new buffers or shapes: warm up and capture anew
                self._key, self._calls = key, 0
                self._graph = self._graph_outs = self._delta = None
            outs = self._run_captured(extra)
        else:
            outs = self._body(extra)
            self.eager_calls += 1
        self._calls += 1
        exe.outputs = [NDArray(o) for o in outs]
        return (outs, dict(self._params),
                _unflatten(self._states[0], self._states[1]))
