"""GoogLeNet / Inception-v1 (counterpart of
``mxnet_tpu/models/googlenet.py``, reference
example/image-classification/symbols/googlenet.py: the Going Deeper with
Convolutions topology, InceptionFactory blocks, no BatchNorm)."""
from .. import symbol as sym


def _conv(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=None,
          suffix=''):
    c = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad,
                        name='conv_%s%s' % (name, suffix))
    return sym.Activation(data=c, act_type='relu',
                          name='relu_%s%s' % (name, suffix))


def _inception(data, n1, n3r, n3, n5r, n5, proj, name, pool='max'):
    """The InceptionFactory block: 1x1 / 1x1->3x3 / 1x1->5x5 /
    pool->1x1-proj branches, channel-concatenated."""
    c1 = _conv(data, n1, (1, 1), name='%s_1x1' % name)
    c3 = _conv(data, n3r, (1, 1), name='%s_3x3' % name, suffix='_reduce')
    c3 = _conv(c3, n3, (3, 3), pad=(1, 1), name='%s_3x3' % name)
    c5 = _conv(data, n5r, (1, 1), name='%s_5x5' % name, suffix='_reduce')
    c5 = _conv(c5, n5, (5, 5), pad=(2, 2), name='%s_5x5' % name)
    p = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                    pool_type=pool, name='%s_pool_%s' % (pool, name))
    p = _conv(p, proj, (1, 1), name='%s_proj' % name)
    return sym.Concat(c1, c3, c5, p, name='ch_concat_%s' % name)


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    # names and pooling conventions follow the reference symbol file
    # EXACTLY (conv1..conv3, in3a..in5b, unnamed-FC auto-name) so
    # reference-trained checkpoints load by parameter name
    x = _conv(data, 64, (7, 7), stride=(2, 2), pad=(3, 3), name="conv1")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _conv(x, 64, (1, 1), name="conv2")
    x = _conv(x, 192, (3, 3), pad=(1, 1), name="conv3")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _inception(x, 64, 96, 128, 16, 32, 32, "in3a")
    x = _inception(x, 128, 128, 192, 32, 96, 64, "in3b")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _inception(x, 192, 96, 208, 16, 48, 64, "in4a")
    x = _inception(x, 160, 112, 224, 24, 64, 64, "in4b")
    x = _inception(x, 128, 128, 256, 24, 64, 64, "in4c")
    x = _inception(x, 112, 144, 288, 32, 64, 64, "in4d")
    x = _inception(x, 256, 160, 320, 32, 128, 128, "in4e")
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _inception(x, 256, 160, 320, 32, 128, 128, "in5a")
    x = _inception(x, 384, 192, 384, 48, 128, 128, "in5b")
    # the reference's fixed 7x7 avg kernel assumes a 7x7 final map (its
    # Caffe ceil-mode lineage); global-avg is shape-robust and identical
    # when the map IS the kernel size
    x = sym.Pooling(x, kernel=(7, 7), stride=(1, 1), pool_type="avg",
                    global_pool=True)
    x = sym.Flatten(x)
    # the reference leaves this FullyConnected unnamed; pin its
    # auto-name so checkpoint keys line up regardless of build order
    x = sym.FullyConnected(x, num_hidden=num_classes,
                           name="fullyconnected0")
    return sym.SoftmaxOutput(x, name="softmax")
