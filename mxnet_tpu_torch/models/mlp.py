"""Multi-layer perceptron (counterpart of ``mxnet_tpu/models/mlp.py``,
reference example/image-classification/symbols/mlp.py)."""
from .. import symbol as sym


def get_symbol(num_classes=10, hidden=(128, 64), **kwargs):
    net = sym.Variable('data')
    net = sym.Flatten(data=net)
    for i, h in enumerate(hidden):
        net = sym.FullyConnected(data=net, num_hidden=h, name='fc%d' % (i + 1))
        net = sym.Activation(data=net, act_type='relu', name='relu%d' % (i + 1))
    net = sym.FullyConnected(data=net, num_hidden=num_classes,
                             name='fc%d' % (len(hidden) + 1))
    return sym.SoftmaxOutput(data=net, name='softmax')
