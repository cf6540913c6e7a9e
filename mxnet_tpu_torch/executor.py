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
executor writes into their tensors in place. The reference's whole-step
``make_train_step`` and its ``compute_dtype`` are not ported.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device
from .ndarray import NDArray
from .symbol import _grad_reqs


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
                 aux_states=None):
        self._symbol = symbol
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
        self.outputs: List[NDArray] = []
        # (gradient-requiring argument views, graph outputs) of the last
        # training forward, consumed by backward()
        self._pending = None

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
                outs, aux_up = self._eval_fn(values, aux_values, True)
            self._pending = (leaves, outs)
            with torch.no_grad():
                for n, v in aux_up.items():
                    self.aux_dict[n]._data.copy_(v)
        else:
            values = {n: a._data for n, a in self.arg_dict.items()}
            with torch.no_grad():
                outs, _ = self._eval_fn(values, aux_values, False)
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
