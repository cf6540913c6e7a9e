"""Inception-ResNet-v2 (counterpart of
``mxnet_tpu/models/inception_resnet_v2.py``, reference example/image-
classification/symbols/inception-resnet-v2.py; Szegedy et al.,
arXiv:1602.07261): residual inception blocks (35/17/8) scaled into the
trunk, stem + two reduction towers, 1536-d head.

The reference file's quirks are reproduced deliberately — block17's
129-channel tower (a known typo in the published symbol, kept so shapes
match its checkpoints) and the scale-times-tower residual adds."""
from .. import symbol as sym


def _conv(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
          with_act=True):
    c = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad)
    b = sym.BatchNorm(data=c)
    return sym.Activation(data=b, act_type="relu") if with_act else b


def _block35(net, in_ch, scale):
    t0 = _conv(net, 32, (1, 1))
    t1 = _conv(_conv(net, 32, (1, 1)), 32, (3, 3), pad=(1, 1))
    t2 = _conv(net, 32, (1, 1))
    t2 = _conv(t2, 48, (3, 3), pad=(1, 1))
    t2 = _conv(t2, 64, (3, 3), pad=(1, 1))
    mixed = sym.Concat(t0, t1, t2)
    out = _conv(mixed, in_ch, (1, 1), with_act=False)
    return sym.Activation(net + scale * out, act_type="relu")


def _block17(net, in_ch, scale):
    t0 = _conv(net, 192, (1, 1))
    t1 = _conv(net, 129, (1, 1))       # sic: the reference's 129
    t1 = _conv(t1, 160, (1, 7), pad=(1, 2))
    t1 = _conv(t1, 192, (7, 1), pad=(2, 1))
    mixed = sym.Concat(t0, t1)
    out = _conv(mixed, in_ch, (1, 1), with_act=False)
    return sym.Activation(net + scale * out, act_type="relu")


def _block8(net, in_ch, scale, with_act=True):
    t0 = _conv(net, 192, (1, 1))
    t1 = _conv(net, 192, (1, 1))
    t1 = _conv(t1, 224, (1, 3), pad=(0, 1))
    t1 = _conv(t1, 256, (3, 1), pad=(1, 0))
    mixed = sym.Concat(t0, t1)
    out = _conv(mixed, in_ch, (1, 1), with_act=False)
    net = net + scale * out
    return sym.Activation(net, act_type="relu") if with_act else net


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    x = _conv(data, 32, (3, 3), stride=(2, 2))
    x = _conv(x, 32, (3, 3))
    x = _conv(x, 64, (3, 3), pad=(1, 1))
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _conv(x, 80, (1, 1))
    x = _conv(x, 192, (3, 3))
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")

    # mixed 5b
    t0 = _conv(x, 96, (1, 1))
    t1 = _conv(_conv(x, 48, (1, 1)), 64, (5, 5), pad=(2, 2))
    t2 = _conv(x, 64, (1, 1))
    t2 = _conv(t2, 96, (3, 3), pad=(1, 1))
    t2 = _conv(t2, 96, (3, 3), pad=(1, 1))
    t3 = sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg")
    t3 = _conv(t3, 64, (1, 1))
    net = sym.Concat(t0, t1, t2, t3)               # 320 ch

    for _ in range(10):
        net = _block35(net, 320, scale=0.17)

    # reduction A
    t0 = _conv(net, 384, (3, 3), stride=(2, 2))
    t1 = _conv(net, 256, (1, 1))
    t1 = _conv(t1, 256, (3, 3), pad=(1, 1))
    t1 = _conv(t1, 384, (3, 3), stride=(2, 2))
    tp = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max")
    net = sym.Concat(t0, t1, tp)                   # 1088 ch

    for _ in range(20):
        net = _block17(net, 1088, scale=0.1)

    # reduction B
    t0 = _conv(_conv(net, 256, (1, 1)), 384, (3, 3), stride=(2, 2))
    t1 = _conv(_conv(net, 256, (1, 1)), 288, (3, 3), stride=(2, 2))
    t2 = _conv(net, 256, (1, 1))
    t2 = _conv(t2, 288, (3, 3), pad=(1, 1))
    t2 = _conv(t2, 320, (3, 3), stride=(2, 2))
    tp = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max")
    net = sym.Concat(t0, t1, t2, tp)               # 2080 ch

    for _ in range(9):
        net = _block8(net, 2080, scale=0.2)
    # the reference runs the FINAL, non-activated block8 at full scale
    net = _block8(net, 2080, scale=1.0, with_act=False)

    net = _conv(net, 1536, (1, 1))
    net = sym.Pooling(net, kernel=(1, 1), global_pool=True,
                      pool_type="avg")
    net = sym.Flatten(net)
    net = sym.Dropout(net, p=0.2)
    net = sym.FullyConnected(net, num_hidden=num_classes)
    return sym.SoftmaxOutput(net, name="softmax")
