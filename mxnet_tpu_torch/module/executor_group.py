"""The executor group of a ``Module``.

Counterpart of ``mxnet_tpu/module/executor_group.py`` (reference
python/mxnet/module/executor_group.py) for one device: one ``Executor``
bound over the whole batch, ``grad_req`` "null" for the data (unless the
module wants input gradients), the labels and the fixed parameters. Each
batch is copied into the bound data and label arrays on the device;
``compute_dtype`` passes to the executor. A group over several devices
waits for the communication slice, and raises.
"""
from __future__ import annotations

from .. import ndarray as nd
from ..base import MXNetError
from ..executor import Executor
from ..ndarray import NDArray


def _name_shape(desc):
    """(name, shape) of a DataDesc or a (name, shape) pair."""
    if hasattr(desc, "name"):
        return desc.name, tuple(desc.shape)
    return desc[0], tuple(desc[1])


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 fixed_param_names=None, grad_req="write",
                 compute_dtype=None):
        if len(contexts) != 1:
            raise MXNetError("an executor group over %d devices is not "
                             "ported (one device)" % len(contexts))
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
        self._bind()
        self.batch_size = _name_shape(data_shapes[0])[1][0]

    def _bind(self):
        shapes = dict(_name_shape(d) for d in
                      list(self.data_shapes) + list(self.label_shapes or []))
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**shapes)
        device = self.contexts[0]
        args = {n: nd.zeros(s, device) for n, s in zip(self.arg_names,
                                                      arg_shapes)}
        grads = {n: nd.zeros(s, device) for n, s in zip(self.arg_names,
                                                       arg_shapes)
                 if self.grad_req.get(n, "null") != "null"}
        auxs = {n: nd.zeros(s, device) for n, s in zip(self.aux_names,
                                                      aux_shapes)}
        self._exec = Executor(self.symbol, device, args, grads,
                              self.grad_req, auxs,
                              compute_dtype=self.compute_dtype)

    # --- computations -----------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        self._load_data(data_batch)
        self._exec.forward(is_train=is_train)
        return self._exec.outputs

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run "
                             "backward")
        self._exec.backward(out_grads)

    def _load_data(self, data_batch):
        """Copy the batch's arrays (host or device) into the bound ones."""
        feeds = list(zip(self.data_names, data_batch.data))
        if self.label_names and data_batch.label:
            feeds += list(zip(self.label_names, data_batch.label))
        for name, val in feeds:
            if name in self._exec.arg_dict:
                self._exec.arg_dict[name][:] = val

    def get_outputs(self, merge_multi_context=True):
        outs = self._exec.outputs
        return outs if merge_multi_context else [[o] for o in outs]

    def get_input_grads(self, merge_multi_context=True):
        grads = [self._exec.grad_dict.get(n) for n in self.data_names]
        return grads if merge_multi_context else [[g] for g in grads]

    def get_params(self, arg_params, aux_params):
        """Host copies of the parameters and aux states into the dicts."""
        for name in self.param_names:
            if name in self._exec.arg_dict:
                arg_params[name] = NDArray(
                    self._exec.arg_dict[name]._data.detach().to(
                        "cpu", copy=True))
        for name in self.aux_names:
            aux_params[name] = NDArray(
                self._exec.aux_dict[name]._data.detach().to("cpu",
                                                            copy=True))

    def set_params(self, arg_params, aux_params, allow_extra=False):
        for values, target, what in ((arg_params, self._exec.arg_dict,
                                      "argument"),
                                     (aux_params, self._exec.aux_dict,
                                      "aux state")):
            for name, val in (values or {}).items():
                if name in target:
                    target[name][:] = val
                elif not allow_extra:
                    raise MXNetError("set_params: unknown %s %r"
                                     % (what, name))

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self._exec.outputs)

    @property
    def param_arrays(self):
        return [[self._exec.arg_dict[n]] for n in self.param_names
                if n in self._exec.arg_dict]

    @property
    def grad_arrays(self):
        """Aligned with :attr:`param_arrays`; [None] for a parameter with
        grad_req null."""
        return [[self._exec.grad_dict.get(n)] for n in self.param_names
                if n in self._exec.arg_dict]
