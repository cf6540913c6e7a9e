"""The executor group of a ``Module``.

Counterpart of ``mxnet_tpu/module/executor_group.py`` (reference
python/mxnet/module/executor_group.py). One ``Executor`` a context, as in
reference MXNet (the JAX package binds one executor over a mesh): the
batch is cut into ``slices`` along its first axis, even, the last taking
the remainder (the JAX package's ``slices``), and executor ``k`` binds
slice ``k``'s shapes on context ``k``. Each batch is copied slice by slice
into the bound data and label arrays on each device; ``grad_req`` is
"null" for the data (unless the module wants input gradients), the labels
and the fixed parameters. ``compute_dtype`` passes to the executors.

``get_outputs`` / ``get_input_grads`` merge the slices (concatenated on
the first context along the first axis) and the metric sees the whole
batch at once, as over the JAX package's mesh. ``param_arrays`` /
``grad_arrays`` hold one tensor a context; ``get_params`` reads the first
context's (the update keeps them equal, ``model._update_params``).

Over k > 1 contexts an op whose training forward couples a batch's rows
cannot see the whole batch: a ``SoftmaxOutput`` / ``MakeLoss`` head with
``normalization="batch"`` is told the global batch (its ``grad_scale``
times its slice's share), which gives the JAX package's numbers; binding
``BatchNorm`` (batch statistics) or a ``normalization="valid"`` head for
training raises, naming the op.

A group bound with a ``shared_group`` (a bucket of ``BucketingModule``)
takes that group's parameter and aux-state arrays, context by context, and
allocates only its own data, label and gradient arrays.
"""
from __future__ import annotations

import json

import torch

from .. import ndarray as nd
from .. import symbol as sym_mod
from ..base import MXNetError
from ..executor import Executor
from ..ndarray import NDArray

#: heads whose gradient divides by a count of the batch's rows
_NORMALIZED_HEADS = ("SoftmaxOutput", "Softmax", "MakeLoss")
#: ops whose training forward reads the whole batch's statistics
_BATCH_STATS = ("BatchNorm", "BatchNorm_v1", "CuDNNBatchNorm")


def _name_shape(desc):
    """(name, shape) of a DataDesc or a (name, shape) pair."""
    if hasattr(desc, "name"):
        return desc.name, tuple(desc.shape)
    return desc[0], tuple(desc[1])


def _false(v):
    return str(v).lower() in ("false", "0", "none")


def _slice_symbol(symbol, share):
    """``symbol`` for one slice of a data-parallel training bind holding
    ``share`` of the batch's rows: each ``normalization="batch"`` head's
    ``grad_scale`` times ``share``, so its gradient divides by the whole
    batch; raises for an op that needs the whole batch at once."""
    graph = json.loads(symbol.tojson())
    changed = False
    for node in graph["nodes"]:
        op, attrs = node["op"], node.get("attrs", {})
        if op in _BATCH_STATS and _false(attrs.get("use_global_stats",
                                                   "False")):
            raise MXNetError(
                "%s (%s) normalizes with its batch's statistics: training "
                "over several contexts would give each context its slice's"
                % (op, node["name"]))
        if op in _NORMALIZED_HEADS:
            norm = attrs.get("normalization", "null")
            if norm == "valid":
                raise MXNetError(
                    "%s (%s) with normalization='valid' divides by the "
                    "batch's valid count, which no slice knows: train it "
                    "on one context" % (op, node["name"]))
            if norm == "batch":
                attrs["grad_scale"] = repr(
                    float(attrs.get("grad_scale", "1.0")) * share)
                changed = True
    return sym_mod.load_json(json.dumps(graph)) if changed else symbol


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 fixed_param_names=None, grad_req="write",
                 compute_dtype=None, shared_group=None):
        self.symbol = symbol
        self.contexts = contexts
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = fixed_param_names or []
        self.compute_dtype = compute_dtype
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        self.data_names = [_name_shape(d)[0] for d in data_shapes]
        self.label_names = [_name_shape(d)[0] for d in label_shapes or []]
        self.batch_size = _name_shape(data_shapes[0])[1][0]
        k = len(contexts)
        if self.batch_size < k:
            raise MXNetError("a batch of %d over %d contexts"
                             % (self.batch_size, k))
        step = self.batch_size // k
        self.slices = [slice(i * step, (i + 1) * step if i < k - 1
                             else self.batch_size) for i in range(k)]

        if isinstance(grad_req, str):
            base = grad_req if for_training else "null"
            self.grad_req = {}
            for name in self.arg_names:
                if name in self.data_names:
                    req = base if inputs_need_grad else "null"
                elif name in self.label_names \
                        or name in self.fixed_param_names:
                    req = "null"
                else:
                    req = base
                self.grad_req[name] = req
        else:
            self.grad_req = dict(grad_req)
        self._bind(shared_group)

    def _bind(self, shared_group=None):
        self.execs = []
        for k, (device, sl) in enumerate(zip(self.contexts, self.slices)):
            n = sl.stop - sl.start
            symbol = self.symbol
            if self.for_training and len(self.contexts) > 1:
                symbol = _slice_symbol(self.symbol, n / self.batch_size)
            shapes = {}
            for d in list(self.data_shapes) + list(self.label_shapes or []):
                name, shape = _name_shape(d)
                if len(self.contexts) > 1:
                    if shape[0] != self.batch_size:
                        raise MXNetError(
                            "%s has %d rows, the batch %d: over several "
                            "contexts every input is cut along its first "
                            "axis" % (name, shape[0], self.batch_size))
                    shape = (n,) + shape[1:]
                shapes[name] = shape
            arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
            shared = {}
            if shared_group is not None:
                exe = shared_group.execs[k]
                shared = {n_: a for n_, a in exe.arg_dict.items()
                          if n_ in self.param_names}
                shared.update(exe.aux_dict)

            def array(name, shape, device=device, shared=shared):
                if name not in shared:
                    return nd.zeros(shape, device)
                if shared[name].shape != tuple(shape):
                    raise MXNetError(
                        "shared array %s has shape %s, this bucket needs %s"
                        % (name, shared[name].shape, tuple(shape)))
                return shared[name]

            args = {n_: array(n_, s) for n_, s in zip(self.arg_names,
                                                      arg_shapes)}
            grads = {n_: nd.zeros(s, device)
                     for n_, s in zip(self.arg_names, arg_shapes)
                     if self.grad_req.get(n_, "null") != "null"}
            auxs = {n_: array(n_, s) for n_, s in zip(self.aux_names,
                                                      aux_shapes)}
            self.execs.append(Executor(symbol, device, args, grads,
                                       self.grad_req, auxs,
                                       compute_dtype=self.compute_dtype))
        self._exec = self.execs[0]

    # --- computations -----------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        self._load_data(data_batch)
        for exe in self.execs:
            exe.forward(is_train=is_train)
        return self.get_outputs()

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run "
                             "backward")
        for exe, sl in zip(self.execs, self.slices):
            if out_grads is None or len(self.execs) == 1:
                exe.backward(out_grads)
            else:
                exe.backward([_rows(g, sl) for g in out_grads])

    def _load_data(self, data_batch):
        """Copy each slice of the batch's arrays (host or device) into its
        executor's bound ones."""
        feeds = list(zip(self.data_names, data_batch.data))
        if self.label_names and data_batch.label:
            feeds += list(zip(self.label_names, data_batch.label))
        one = len(self.execs) == 1
        for name, val in feeds:
            for exe, sl in zip(self.execs, self.slices):
                if name in exe.arg_dict:
                    exe.arg_dict[name][:] = val if one else _rows(val, sl)

    def install_monitor(self, mon):
        for exe in self.execs:
            mon.install(exe)

    def _merged(self, per_exec):
        """Each slot's arrays of every executor, joined along the first
        axis on the first context (as is with one context)."""
        if len(self.execs) == 1:
            return list(per_exec[0])
        dev = self.execs[0]._device
        out = []
        for parts in zip(*per_exec):
            if parts[0] is None:
                out.append(None)
            else:
                out.append(NDArray(torch.cat([p._data.to(dev)
                                              for p in parts])))
        return out

    def get_outputs(self, merge_multi_context=True):
        per_exec = [exe.outputs for exe in self.execs]
        if merge_multi_context:
            return self._merged(per_exec)
        return [list(o) for o in zip(*per_exec)]

    def get_input_grads(self, merge_multi_context=True):
        per_exec = [[exe.grad_dict.get(n) for n in self.data_names]
                    for exe in self.execs]
        if merge_multi_context:
            return self._merged(per_exec)
        return [list(g) for g in zip(*per_exec)]

    def get_params(self, arg_params, aux_params):
        """Host copies of the first context's parameters and aux states
        into the dicts."""
        exe = self._exec
        for name in self.param_names:
            if name in exe.arg_dict:
                arg_params[name] = NDArray(
                    exe.arg_dict[name]._data.detach().to("cpu", copy=True))
        for name in self.aux_names:
            aux_params[name] = NDArray(
                exe.aux_dict[name]._data.detach().to("cpu", copy=True))

    def set_params(self, arg_params, aux_params, allow_extra=False):
        for exe in self.execs:
            for values, target, what in ((arg_params, exe.arg_dict,
                                          "argument"),
                                         (aux_params, exe.aux_dict,
                                          "aux state")):
                for name, val in (values or {}).items():
                    if name in target:
                        target[name][:] = val
                    elif not allow_extra:
                        raise MXNetError("set_params: unknown %s %r"
                                         % (what, name))

    def update_metric(self, eval_metric, labels):
        """The metric over the whole batch's outputs."""
        eval_metric.update(labels, self.get_outputs())

    @property
    def param_arrays(self):
        """A list a parameter (grad_req aside) of its array on each
        context."""
        return [[exe.arg_dict[n] for exe in self.execs]
                for n in self.param_names if n in self._exec.arg_dict]

    @property
    def grad_arrays(self):
        """Aligned with :attr:`param_arrays`; [None, ...] for a parameter
        with grad_req null."""
        return [[exe.grad_dict.get(n) for exe in self.execs]
                for n in self.param_names if n in self._exec.arg_dict]


def _rows(val, sl):
    """Rows ``sl`` of a batch array (an NDArray, a tensor or numpy)."""
    if isinstance(val, NDArray):
        return val._data[sl]
    return val[sl]
