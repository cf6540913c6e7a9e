"""Symbolic RNN cells.

Counterpart of ``mxnet_tpu/rnn/rnn_cell.py`` (reference python/mxnet/rnn/
rnn_cell.py): ``RNNCell`` / ``LSTMCell`` / ``GRUCell`` with ``unroll``,
``SequentialRNNCell``, ``BidirectionalCell``, ``DropoutCell``, the
``ModifierCell`` base with ``ZoneoutCell`` and ``ResidualCell``, and
``FusedRNNCell``, whose ``unroll`` emits the
fused ``RNN`` op (``ops/rnn_fused.py``: every LSTM step through the
``lstm_step`` kernel on the card) and whose ``unfuse`` gives the
equivalent stack of explicit cells. Parameter names, gate orders and the
packed blob's layout are the reference's, so weights cross between the
packages and between the fused and the unfused form
(``unpack_weights`` / ``pack_weights``). ``DropoutCell`` and
``ZoneoutCell`` draw through the ``Dropout`` op, so they act in training
only.
"""
from __future__ import annotations

from .. import ndarray as nd
from .. import symbol
from ..base import MXNetError


def _batch_ref(sym_, batch_axis, ndim):
    """A (batch, 1) zero symbol whose batch dim follows ``sym_``'s, so
    begin states get their batch size by forward shape inference (the
    reference's begin states have a 0 batch dim, unified backwards)."""
    ref = sym_
    for ax in range(ndim):
        if ax != batch_axis:
            ref = symbol.slice_axis(ref, axis=ax, begin=0, end=1)
    return symbol.Reshape(ref, shape=(-1, 1)) * 0


def _zeros_like_batch(ref_n1):
    """A begin_state func: zeros of the state's shape, its 0 dims the
    batch of ``ref_n1`` (a broadcast view, nothing allocated per dim)."""

    def func(name=None, shape=None, **kw):
        s = tuple(shape)
        rshape = tuple(-1 if d == 0 else 1 for d in s)
        return symbol.broadcast_to(symbol.Reshape(ref_n1, shape=rshape),
                                   shape=s)

    return func


class RNNParams:
    """Container for shared cell parameters (reference RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """Abstract cell (reference BaseRNNCell)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, **kwargs):
        """One symbol per state, made by ``func(name=..., shape=...,
        __layout__=...)`` from ``state_info``."""
        assert not self._modified
        states = []
        for info in self.state_info:
            self._init_counter += 1
            if info is not None:
                kwargs.update(info)
            states.append(func(name="%sbegin_state_%d"
                               % (self._prefix, self._init_counter),
                               **kwargs))
        return states

    def unpack_weights(self, args):
        """Split each fused gate weight and bias (``<prefix>i2h_weight``
        ...) into per-gate arrays (``<prefix>i2h_i_weight`` ...)."""
        args = args.copy()
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ["i2h", "h2h"]:
            weight = args.pop("%s%s_weight" % (self._prefix, group_name))
            bias = args.pop("%s%s_bias" % (self._prefix, group_name))
            for j, gate in enumerate(self._gate_names):
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                args[wname] = weight[j * h:(j + 1) * h].copy()
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                args[bname] = bias[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        """The inverse of :meth:`unpack_weights` (NDArrays)."""
        args = args.copy()
        if not self._gate_names:
            return args
        for group_name in ["i2h", "h2h"]:
            weight, bias = [], []
            for gate in self._gate_names:
                weight.append(args.pop("%s%s%s_weight"
                                       % (self._prefix, group_name, gate)))
                bias.append(args.pop("%s%s%s_bias"
                                     % (self._prefix, group_name, gate)))
            args["%s%s_weight" % (self._prefix, group_name)] = \
                nd.concatenate(weight)
            args["%s%s_bias" % (self._prefix, group_name)] = \
                nd.concatenate(bias)
        return args

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        """Unroll over ``length`` steps; returns (outputs, states)."""
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            inputs = [symbol.Variable("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        elif isinstance(inputs, symbol.Symbol):
            assert len(inputs) == 1
            inputs = symbol.SliceChannel(inputs, axis=axis,
                                         num_outputs=length, squeeze_axis=1)
            inputs = [inputs[i] for i in range(length)]
        if begin_state is None:
            begin_state = self.begin_state(
                func=_zeros_like_batch(_batch_ref(inputs[0], 0, 2)))
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = [symbol.expand_dims(i, axis=axis) for i in outputs]
            outputs = symbol.Concat(*outputs, dim=axis)
        return outputs, states


class RNNCell(BaseRNNCell):
    """Vanilla tanh / relu RNN cell."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden,
                                    name="%sh2h" % name)
        output = symbol.Activation(i2h + h2h, act_type=self._activation,
                                   name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell; gate order i, f, g (``_c``), o."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        from ..initializer import LSTMBias

        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias",
                                   init=LSTMBias(forget_bias=forget_bias))
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_i", "_f", "_c", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%sh2h" % name)
        gates = symbol.SliceChannel(i2h + h2h, num_outputs=4,
                                    name="%sslice" % name)
        in_gate = symbol.Activation(gates[0], act_type="sigmoid",
                                    name="%si" % name)
        forget_gate = symbol.Activation(gates[1], act_type="sigmoid",
                                        name="%sf" % name)
        in_transform = symbol.Activation(gates[2], act_type="tanh",
                                         name="%sc" % name)
        out_gate = symbol.Activation(gates[3], act_type="sigmoid",
                                     name="%so" % name)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell; gate order r, z, o."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_r", "_z", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_h = states[0]
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=prev_h, weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%sh2h" % name)
        i2h_r, i2h_z, i2h = symbol.SliceChannel(i2h, num_outputs=3,
                                                name="%si2h_slice" % name)
        h2h_r, h2h_z, h2h = symbol.SliceChannel(h2h, num_outputs=3,
                                                name="%sh2h_slice" % name)
        reset_gate = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid",
                                       name="%sr_act" % name)
        update_gate = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid",
                                        name="%sz_act" % name)
        next_h_tmp = symbol.Activation(i2h + reset_gate * h2h,
                                       act_type="tanh",
                                       name="%sh_act" % name)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Every layer and step of a multi-layer RNN in one ``RNN`` op, over a
    packed parameter blob ``<prefix>parameters`` tagged with the
    ``FusedRNN`` initializer. ``unfuse()`` gives the explicit-cell
    stack; ``unpack_weights`` / ``pack_weights`` convert between the blob
    and its per-gate arrays (the reference MXNet's names)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        from .. import initializer

        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = 2 if bidirectional else 1
        self._parameter = self.params.get(
            "parameters",
            init=initializer.FusedRNN(None, num_hidden=num_hidden,
                                      num_layers=num_layers, mode=mode,
                                      bidirectional=bidirectional,
                                      forget_bias=forget_bias))

    @property
    def state_info(self):
        b = self._directions
        n = (self._mode == "lstm") + 1
        return [{"shape": (b * self._num_layers, 0, self._num_hidden),
                 "__layout__": "LNC"} for _ in range(n)]

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _slice_weights(self, arr, li, lh):
        """name -> view of the packed blob ``arr`` (numpy or NDArray) for
        each per-gate weight and bias: per layer and direction the i2h then
        the h2h gate matrices, then every bias, i2h before h2h."""
        args = {}
        h = self._num_hidden
        p = 0
        for layer in range(self._num_layers):
            ni = lh * self._directions if layer > 0 else li
            for direction in "lr"[:self._directions]:
                for part, cols in (("i2h", ni), ("h2h", lh)):
                    for gate in self._gate_names:
                        name = "%s%s%d_%s%s_weight" % (
                            self._prefix, direction, layer, part, gate)
                        args[name] = arr[p:p + h * cols].reshape((h, cols))
                        p += h * cols
        for layer in range(self._num_layers):
            for direction in "lr"[:self._directions]:
                for part in ("i2h", "h2h"):
                    for gate in self._gate_names:
                        name = "%s%s%d_%s%s_bias" % (
                            self._prefix, direction, layer, part, gate)
                        args[name] = arr[p:p + h]
                        p += h
        if p != arr.size:
            raise MXNetError("FusedRNNCell: a blob of %d does not hold %d "
                             "parameters" % (arr.size, p))
        return args

    def _num_input(self, size):
        """The first layer's input size, from the blob's length."""
        b, m, h = self._directions, self._num_gates, self._num_hidden
        return size // b // h // m - (self._num_layers - 1) * (
            h + b * h + 2) - h - 2

    def unpack_weights(self, args):
        """The packed blob replaced by per-gate copies
        (``<prefix>l0_i2h_i_weight`` ...)."""
        args = args.copy()
        arr = args.pop(self._parameter.name)
        pieces = self._slice_weights(arr, self._num_input(arr.size),
                                     self._num_hidden)
        args.update({name: a.copy() for name, a in pieces.items()})
        return args

    def pack_weights(self, args):
        """Per-gate arrays (NDArrays) packed into a new blob."""
        args = args.copy()
        b, m, h = self._directions, self._num_gates, self._num_hidden
        w0 = args["%sl0_i2h%s_weight" % (self._prefix, self._gate_names[0])]
        ni = w0.shape[1]
        total = (ni + h + 2) * h * m * b + (self._num_layers - 1) * m * h \
            * (h + b * h + 2) * b
        arr = nd.zeros((total,), w0.context, w0._data.dtype)
        for name, view in self._slice_weights(arr, ni, h).items():
            view[:] = args.pop(name)
        args[self._parameter.name] = arr
        return args

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            inputs = [symbol.Variable("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        if isinstance(inputs, list):
            inputs = [symbol.expand_dims(i, axis=1) for i in inputs]
            inputs = symbol.Concat(*inputs, dim=1)
            axis = 1
        if axis == 1:  # NTC -> TNC: the op scans over a leading time axis
            inputs = symbol.SwapAxis(inputs, dim1=0, dim2=1)
        if begin_state is None:
            begin_state = self.begin_state(
                func=_zeros_like_batch(_batch_ref(inputs, 1, 3)))
        states = begin_state
        rnn_kwargs = dict(
            data=inputs, parameters=self._parameter, state=states[0],
            state_size=self._num_hidden, num_layers=self._num_layers,
            bidirectional=self._bidirectional, p=self._dropout,
            state_outputs=self._get_next_state, mode=self._mode,
            name=self._prefix + "rnn")
        if self._mode == "lstm":
            rnn_kwargs["state_cell"] = states[1]
        rnn = symbol.RNN(**rnn_kwargs)
        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == "lstm":
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if axis == 1:
            outputs = symbol.SwapAxis(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs = symbol.SliceChannel(outputs, axis=axis,
                                          num_outputs=length,
                                          squeeze_axis=1)
            outputs = [outputs[i] for i in range(length)]
        return outputs, states

    def unfuse(self):
        """The equivalent stack of explicit cells, named so that
        :meth:`unpack_weights`' arrays pack into it."""
        if self._dropout > 0:
            raise MXNetError("FusedRNNCell.unfuse with dropout needs "
                             "DropoutCell, which a later slice of the port "
                             "brings")
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden,
                                          activation="relu", prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden,
                                          activation="tanh", prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        stack = SequentialRNNCell()
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_%d_" % (self._prefix, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Cells stacked: each one's output is the next one's input."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params
            cell.params._params.update(self.params._params)
            self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])


class DropoutCell(BaseRNNCell):
    """Dropout on the stepped output, no state (reference rnn_cell.py
    DropoutCell)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    """A cell wrapped around another, sharing its parameters."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError()


class ZoneoutCell(ModifierCell):
    """Zoneout (reference rnn_cell.py ZoneoutCell): in training each
    element of the output (``zoneout_outputs``) and of each state
    (``zoneout_states``) keeps its previous value with that probability,
    through ``where`` on a ``Dropout`` of ones. The first step's previous
    output is zeros of the output's shape, as the reference's 0-dim
    unification makes ``zeros((0, 0))``; the JAX package's
    ``zeros((0, 0))`` fails shape inference there."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        if isinstance(base_cell, FusedRNNCell):
            raise MXNetError("FusedRNNCell doesn't support zoneout. Please "
                             "unfuse first.")
        if isinstance(base_cell, BidirectionalCell):
            raise MXNetError("BidirectionalCell doesn't support zoneout "
                             "since it doesn't support step. Please add "
                             "ZoneoutCell to the cells underneath instead.")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell = self.base_cell
        p_outputs, p_states = self.zoneout_outputs, self.zoneout_states
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return symbol.Dropout(symbol.ones_like(like), p=p)

        prev_output = self.prev_output if self.prev_output is not None \
            else symbol.ones_like(next_output) * 0.0
        output = (symbol.where(mask(p_outputs, next_output), next_output,
                               prev_output)
                  if p_outputs != 0.0 else next_output)
        states_out = ([symbol.where(mask(p_states, new_s), new_s, old_s)
                       for new_s, old_s in zip(next_states, states)]
                      if p_states != 0.0 else next_states)
        self.prev_output = output
        return output, states_out


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol.elemwise_add(output, inputs,
                                     name="%s_plus_residual" % output.name)
        return output, states


class BidirectionalCell(BaseRNNCell):
    """A left-to-right and a right-to-left cell over the same inputs,
    their outputs concatenated; it unrolls only."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            assert l_cell._own_params and r_cell._own_params
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        raise NotImplementedError("Bidirectional cannot be stepped. Please "
                                  "use unroll")

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=None):
        self.reset()
        if inputs is None:
            inputs = [symbol.Variable("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        elif isinstance(inputs, symbol.Symbol):
            assert len(inputs) == 1
            inputs = symbol.SliceChannel(inputs, axis=layout.find("T"),
                                         num_outputs=length, squeeze_axis=1)
            inputs = [inputs[i] for i in range(length)]
        if begin_state is None:
            begin_state = self.begin_state(
                func=_zeros_like_batch(_batch_ref(inputs[0], 0, 2)))
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:n_l],
            layout=layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=begin_state[n_l:], layout=layout,
            merge_outputs=False)
        outputs = [symbol.Concat(l_o, r_o, dim=1,
                                 name="%st%d" % (self._output_prefix, i))
                   for i, (l_o, r_o) in enumerate(
                       zip(l_outputs, reversed(r_outputs)))]
        if merge_outputs:
            axis = layout.find("T")
            outputs = [symbol.expand_dims(o, axis=axis) for o in outputs]
            outputs = symbol.Concat(*outputs, dim=axis)
        return outputs, l_states + r_states


def _cells_unpack_weights(cells, args):
    for cell in cells:
        args = cell.unpack_weights(args)
    return args


def _cells_pack_weights(cells, args):
    for cell in cells:
        args = cell.pack_weights(args)
    return args
