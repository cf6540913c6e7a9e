"""LSTM language model (PTB; the reference's example/rnn/
lstm_bucketing.py).

Counterpart of ``mxnet_tpu/models/lstm_lm.py``, with the same node and
parameter names: Embedding -> stacked LSTM unrolled over ``seq_len`` ->
a per-step FullyConnected -> SoftmaxOutput over the flattened
(batch * time) axis. ``fused=True`` is one ``RNN`` op over a packed blob
(``FusedRNNCell``; every step through the ``lstm_step`` kernel on the
card), ``fused=False`` a ``SequentialRNNCell`` of ``LSTMCell``s.
``dropout`` acts between the layers in training: the ``RNN`` op's ``p``
when fused, a ``DropoutCell`` between the cells when not.
"""
from .. import symbol as sym
from ..rnn import rnn_cell


def get_symbol(num_classes=10000, seq_len=35, num_embed=200, num_hidden=200,
               num_layers=2, dropout=0.0, fused=False, **kwargs):
    data = sym.Variable('data')          # (batch, seq_len) ids as floats
    embed = sym.Embedding(data=data, input_dim=num_classes,
                          output_dim=num_embed, name='embed')
    if fused:
        stack = rnn_cell.FusedRNNCell(num_hidden, num_layers=num_layers,
                                      mode='lstm', dropout=dropout,
                                      prefix='lstm_')
    else:
        stack = rnn_cell.SequentialRNNCell()
        for i in range(num_layers):
            stack.add(rnn_cell.LSTMCell(num_hidden, prefix='lstm_l%d_' % i))
            if dropout > 0 and i < num_layers - 1:
                stack.add(rnn_cell.DropoutCell(dropout,
                                               prefix='drop_l%d_' % i))

    outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True,
                              layout='NTC')
    pred = sym.Reshape(data=outputs, shape=(-1, num_hidden))
    pred = sym.FullyConnected(data=pred, num_hidden=num_classes, name='pred')
    label = sym.Variable('softmax_label')
    label = sym.Reshape(data=label, shape=(-1,))
    return sym.SoftmaxOutput(data=pred, label=label, name='softmax')
