"""Imperative autograd.

Counterpart of ``mxnet_tpu/autograd.py`` (reference src/ndarray/autograd.
{h,cc}). The reference records every imperative call on a thread-local
tape and replays it through ``jax.vjp`` at ``backward``; here PyTorch's own
graph is the tape. :func:`mark_variables` makes each variable's tensor a
leaf that requires grad, ``ndarray.invoke`` runs ops with grad enabled only
inside :func:`record` (and hands them ``is_train`` from the training flag),
and :func:`backward` differentiates the heads with ``torch.autograd.grad``
and lands each variable's gradient in its attached buffer as its
``grad_req`` says: ``write`` overwrites, ``add`` accumulates, ``null``
skips.

A variable is marked before the ops that use it are recorded: PyTorch's
graph starts at tensors that required grad when the op ran (the JAX
package replays its tape, so it may mark later; :func:`grad` here raises
for a variable marked too late). Marked variables are held weakly: one
that is garbage collected drops out. Writes into a marked tensor
(``x[:] = ...``, ``CustomOp.assign``, the optimizer's updates) run under
``no_grad`` into its storage, so the variable stays the same leaf.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Tuple

import torch

from .base import MXNetError

_GRAD_REQS = ("null", "write", "add")


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        # id(variable) -> (weakref to the variable NDArray, grad NDArray,
        # grad_req), in marking order
        self.marked: Dict[int, Tuple[weakref.ref, object, str]] = {}


_state = _State()


def is_recording() -> bool:
    return _state.recording


def is_training() -> bool:
    return _state.training


def set_recording(flag: bool) -> bool:
    """Set the recording flag; returns the previous one."""
    old = _state.recording
    _state.recording = bool(flag)
    return old


def set_training(flag: bool) -> bool:
    """Set the training flag; returns the previous one."""
    old = _state.training
    _state.training = bool(flag)
    return old


class _RecordScope:
    def __init__(self, recording, train_mode):
        self._recording = recording
        self._train = train_mode

    def __enter__(self):
        self._old_rec = set_recording(self._recording)
        self._old_train = set_training(self._train)
        return self

    def __exit__(self, *args):
        set_recording(self._old_rec)
        set_training(self._old_train)


def record(train_mode: bool = True):
    """Scope in which imperative ops are recorded for :func:`backward`,
    in training mode unless ``train_mode`` is False."""
    return _RecordScope(True, train_mode)


def pause(train_mode: bool = False):
    """Scope in which nothing is recorded."""
    return _RecordScope(False, train_mode)


def train_mode():
    """Scope in training mode; recording unchanged."""
    return _RecordScope(_state.recording, True)


def predict_mode():
    """Scope in prediction mode; recording unchanged."""
    return _RecordScope(_state.recording, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to arrays (reference MarkVariables,
    autograd.cc:54-68): each variable's tensor becomes a leaf that
    requires grad, and its ``.grad`` is the given buffer."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    if not len(variables) == len(gradients) == len(grad_reqs):
        raise MXNetError("mark_variables: %d variables, %d gradients, %d "
                         "grad_reqs" % (len(variables), len(gradients),
                                        len(grad_reqs)))
    for var, grad, req in zip(variables, gradients, grad_reqs):
        if req not in _GRAD_REQS:
            raise MXNetError("grad_req must be one of %s, not %r"
                             % (_GRAD_REQS, req))
        if not var._data.is_leaf:
            var._data = var._data.detach()
        var._data.requires_grad_(True)
        var._grad = grad
        _state.marked[id(var)] = (weakref.ref(var), grad, req)


def _live_marked() -> List[Tuple[object, object, str]]:
    """(variable, grad, req) of every marked variable still alive; the
    dead ones are dropped."""
    live = []
    for key, (ref, grad, req) in list(_state.marked.items()):
        var = ref()
        if var is None:
            del _state.marked[key]
        else:
            live.append((var, grad, req))
    return live


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (weighted by ``head_grads``, ones by default)
    with respect to every marked variable, written into the attached
    buffers as each ``grad_req`` says (reference ComputeGradient,
    autograd.cc:138-205). ``train_mode`` is accepted for the reference's
    signature: the ops ran in the mode they were recorded in."""
    del train_mode
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
    if head_grads is not None and not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    marked = _live_marked()
    if not marked:
        raise MXNetError("no variables marked for gradient (call "
                         "mark_variables or attach_grad)")
    outs = [h._data for h in heads]
    if not all(o.requires_grad for o in outs):
        raise MXNetError("backward head was not computed under record() "
                         "from a marked variable")
    if head_grads is None:
        grads_in = [torch.ones_like(o) for o in outs]
    else:
        grads_in = [g._data if hasattr(g, "_data") else torch.as_tensor(g)
                    for g in head_grads]
    # a variable whose handle was rebound to a tensor outside the graph
    # gets no gradient (zeros under "write"), like an unused one
    leaves = [i for i, (v, _, _) in enumerate(marked)
              if v._data.requires_grad]
    found = torch.autograd.grad(outs, [marked[i][0]._data for i in leaves],
                                grads_in, retain_graph=retain_graph,
                                allow_unused=True)
    grads = [None] * len(marked)
    for i, g in zip(leaves, found):
        grads[i] = g
    with torch.no_grad():
        for (_, buf, req), g in zip(marked, grads):
            if req == "null" or buf is None:
                continue
            if req == "add":
                if g is not None:
                    buf._data.add_(g)
            elif g is None:
                buf._data.zero_()
            else:
                buf._data.copy_(g)


def grad(heads, variables, head_grads=None, retain_graph=False,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, as new arrays
    (the reference marks fresh buffers and runs :func:`backward`)."""
    del create_graph
    from .ndarray import NDArray

    late = [i for i, v in enumerate(variables) if not v._data.requires_grad]
    if late:
        raise MXNetError("grad: variables %s were not marked (attach_grad "
                         "or mark_variables) before record()" % late)
    grads = [NDArray(torch.zeros_like(v._data)) for v in variables]
    mark_variables(variables, grads, "write")
    backward(heads, head_grads, retain_graph=retain_graph,
             train_mode=train_mode)
    return grads
