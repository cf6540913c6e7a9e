"""The fused multi-layer ``RNN`` operator.

Counterpart of ``mxnet_tpu/ops/rnn_fused.py`` (reference src/operator/
rnn.cc, cudnn_rnn-inl.h: the cuDNN-only fused RNN). Each layer and
direction hoists its input projection out of the time loop (one
``torch.matmul`` over the whole sequence) and then scans over time. An
LSTM scan goes through :class:`LSTMScan`, whose forward calls the
``lstm_step`` kernel (``kernels/lstm.py``) once per step, writing h'
straight into the output sequence, and whose backward recomputes through
the plain scan and differentiates it, as the reference's
``_lstm_fused_bwd`` does (the reference has no backward kernel). There is
no selection gate: every LSTM scan takes the kernel on a CUDA tensor. GRU
and vanilla RNN scans are plain torch.

The packed parameter blob has the reference's (and cuDNN's) layout: per
layer, per direction, the i2h then the h2h weight, then every bias pair,
so ``FusedRNNCell`` slices and the reference's checkpoints match.
Layouts: data (T, N, input_size); states (num_layers * dirs, N, H).
Dropout between layers (``p > 0`` in training): after every layer but
the last, the layer's whole output times a keep mask over ``1 - p``, one
mask a layer drawn in layer order from the device's generator
(``random.keep_mask``, as the ``Dropout`` op draws), as the reference
does; a plain elementwise pass, the recurrence stays on the kernel.
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import MXNetError
from .kernels.lstm import lstm_step
from .registry import defop, get_op

_NUM_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(num_layers, input_size, state_size, mode,
                   bidirectional=False):
    """Total packed parameter count (reference rnn-inl.h
    GetRnnParamSize)."""
    gates = _NUM_GATES[mode]
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        ni = input_size if layer == 0 else state_size * dirs
        size += dirs * gates * state_size * (ni + state_size)
    size += num_layers * dirs * gates * state_size * 2
    return size


def _unpack_params(params, num_layers, input_size, state_size, mode, dirs):
    """[layer][direction] -> [wi, wh, bi, bh], views into ``params``."""
    gates = _NUM_GATES[mode]
    h = state_size
    out = []
    p = 0
    for layer in range(num_layers):
        ni = input_size if layer == 0 else h * dirs
        layer_params = []
        for _ in range(dirs):
            wi = params[p:p + gates * h * ni].reshape(gates * h, ni)
            p += gates * h * ni
            wh = params[p:p + gates * h * h].reshape(gates * h, h)
            p += gates * h * h
            layer_params.append([wi, wh])
        out.append(layer_params)
    for layer in range(num_layers):
        for d in range(dirs):
            bi = params[p:p + gates * h]
            p += gates * h
            bh = params[p:p + gates * h]
            p += gates * h
            out[layer][d].extend([bi, bh])
    return out


def _lstm_scan_plain(ib, h0, c0, wh, h):
    """The plain LSTM scan over ``ib`` (T, N, 4H) in the inputs' type
    (the reference's ``_lstm_scan_jnp``); returns (ys, h_last, c_last)."""
    hh, c = h0, c0
    ys = []
    for xt in ib:
        gates = xt + hh @ wh.t()
        i = torch.sigmoid(gates[:, 0 * h:1 * h])
        f = torch.sigmoid(gates[:, 1 * h:2 * h])
        g = torch.tanh(gates[:, 2 * h:3 * h])
        o = torch.sigmoid(gates[:, 3 * h:4 * h])
        c = f * c + i * g
        hh = o * torch.tanh(c)
        ys.append(hh)
    if not ys:
        return ib.new_empty((0,) + tuple(h0.shape)), h0, c0
    return torch.stack(ys), hh, c


class LSTMScan(torch.autograd.Function):
    """The LSTM time loop (the reference's ``_lstm_scan_fused``): forward
    one ``lstm_step`` per step, each writing h' into ``ys[t]`` and c' into
    one of two buffers; backward recomputes through
    :func:`_lstm_scan_plain` under autograd and returns its gradients with
    respect to ``ib``, ``h0``, ``c0`` and ``wh``."""

    @staticmethod
    def forward(ctx, ib, h0, c0, wh):
        ctx.save_for_backward(ib, h0, c0, wh)
        steps, n, hidden = ib.shape[0], h0.shape[0], h0.shape[1]
        ys = ib.new_empty((steps, n, hidden), dtype=h0.dtype)
        cbuf = ib.new_empty((2, n, hidden), dtype=c0.dtype)
        h, c = h0, c0
        for t in range(steps):
            h, c = lstm_step(ib[t], h, c, wh, h_out=ys[t],
                             c_out=cbuf[t % 2])
        return ys, h.clone(), c.clone()

    @staticmethod
    def backward(ctx, gys, gh, gc):
        ib, h0, c0, wh = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (ib, h0, c0, wh)]
            outs = _lstm_scan_plain(*leaves, h0.shape[1])
        pairs = [(o, g) for o, g in zip(outs, (gys, gh, gc))
                 if g is not None and o.requires_grad]
        return torch.autograd.grad([o for o, _ in pairs], leaves,
                                   [g for _, g in pairs], allow_unused=True)


def _lstm_scan(x_seq, h0, c0, wi, wh, bi, bh):
    """One direction of one LSTM layer; gate order i, f, g, o (cuDNN's,
    matching ``FusedRNNCell``'s gate names)."""
    ib = torch.matmul(x_seq, wi.t()) + (bi + bh)  # (T, N, 4H), hoisted
    return LSTMScan.apply(ib, h0, c0, wh)


def _gru_scan(x_seq, h0, wi, wh, bi, bh, h):
    """GRU scan; gate order r, z, o (cuDNN's)."""
    ib = torch.matmul(x_seq, wi.t()) + bi  # (T, N, 3H)
    hh, ys = h0, []
    for xt in ib:
        hb = hh @ wh.t() + bh
        r = torch.sigmoid(xt[:, 0 * h:1 * h] + hb[:, 0 * h:1 * h])
        z = torch.sigmoid(xt[:, 1 * h:2 * h] + hb[:, 1 * h:2 * h])
        o = torch.tanh(xt[:, 2 * h:3 * h] + r * hb[:, 2 * h:3 * h])
        hh = (1 - z) * o + z * hh
        ys.append(hh)
    return torch.stack(ys), hh


def _rnn_scan(x_seq, h0, wi, wh, bi, bh, act):
    """Vanilla RNN scan: h' = act(x wi^T + bi + bh + h wh^T)."""
    ib = torch.matmul(x_seq, wi.t()) + (bi + bh)
    hh, ys = h0, []
    for xt in ib:
        hh = act(xt + hh @ wh.t())
        ys.append(hh)
    return torch.stack(ys), hh


def _rnn_out_shapes(attrs, data):
    h = int(attrs["state_size"])
    dirs = 2 if attrs["bidirectional"] else 1
    state = (int(attrs["num_layers"]) * dirs, data.shape[1], h)
    return (tuple(data.shape[:2]) + (h * dirs,), state, state)


@defop(
    "RNN",
    arg_names=lambda attrs: (
        ("data", "parameters", "state", "state_cell")
        if attrs.get("mode", "lstm") == "lstm"
        else ("data", "parameters", "state")),
    param_spec={"state_size": 0, "num_layers": 1, "bidirectional": False,
                "mode": "lstm", "p": 0.0, "state_outputs": False,
                "pkeep_": 1.0, "lstm_q_": False},
    num_outputs=lambda attrs: (
        1 if not attrs.get("state_outputs")
        else (3 if attrs.get("mode", "lstm") == "lstm" else 2)),
    simple=False, needs_rng=True,
)
def _rnn(attrs, inputs, aux, ctx):
    """Fused RNN forward (see the module docstring); data (T, N, I)."""
    mode = attrs["mode"]
    if mode not in _NUM_GATES:
        raise MXNetError("RNN: unknown mode %r" % mode)
    n_out = 1 if not attrs["state_outputs"] else (3 if mode == "lstm"
                                                  else 2)
    data = inputs[0]
    if data.device.type == "meta":
        # shape inference (symbol.infer_shape): nothing to compute
        shapes = _rnn_out_shapes(attrs, data)[:n_out]
        return tuple(data.new_empty(s) for s in shapes), ()
    dropout = float(attrs["p"])
    if mode == "lstm":
        data, params, state, state_cell = inputs
    else:
        data, params, state = inputs
        state_cell = None
    h = int(attrs["state_size"])
    num_layers = int(attrs["num_layers"])
    dirs = 2 if attrs["bidirectional"] else 1
    layer_params = _unpack_params(params, num_layers, data.shape[2], h,
                                  mode, dirs)

    x = data
    h_states, c_states = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(dirs):
            wi, wh, bi, bh = layer_params[layer][d]
            idx = layer * dirs + d
            h0 = state[idx]
            x_dir = x if d == 0 else torch.flip(x, (0,))
            if mode == "lstm":
                ys, h_last, c_last = _lstm_scan(x_dir, h0, state_cell[idx],
                                                wi, wh, bi, bh)
                c_states.append(c_last)
            elif mode == "gru":
                ys, h_last = _gru_scan(x_dir, h0, wi, wh, bi, bh, h)
            else:
                act = torch.relu if mode == "rnn_relu" else torch.tanh
                ys, h_last = _rnn_scan(x_dir, h0, wi, wh, bi, bh, act)
            if d == 1:
                ys = torch.flip(ys, (0,))
            outs.append(ys)
            h_states.append(h_last)
        x = outs[0] if dirs == 1 else torch.cat(outs, dim=2)
        if dropout > 0 and ctx.is_train and layer != num_layers - 1:
            keep = 1.0 - dropout
            x = x * _random.keep_mask(x.shape, keep, ctx.rng, x.device,
                                      x.dtype) / keep

    if not attrs["state_outputs"]:
        return (x,), ()
    h_out = torch.stack(h_states, dim=0)
    if mode == "lstm":
        return (x, h_out, torch.stack(c_states, dim=0)), ()
    return (x, h_out), ()


def _rnn_infer(attrs, shapes):
    """Parameter-blob and state shapes from the data shape, for
    ``simple_bind``."""
    data = shapes[0]
    if data is None:
        return shapes
    size = rnn_param_size(int(attrs["num_layers"]), data[2],
                          int(attrs["state_size"]), attrs["mode"],
                          bool(attrs["bidirectional"]))
    if shapes[1] is None:
        shapes[1] = (size,)
    dirs = 2 if attrs["bidirectional"] else 1
    state_shape = (int(attrs["num_layers"]) * dirs, data[1],
                   int(attrs["state_size"]))
    for i in range(2, len(shapes)):
        if shapes[i] is None:
            shapes[i] = state_shape
    return shapes


get_op("RNN").infer_params = _rnn_infer
