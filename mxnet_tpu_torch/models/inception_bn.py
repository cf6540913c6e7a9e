"""Inception-BN (counterpart of ``mxnet_tpu/models/inception_bn.py``,
reference example/image-classification/symbols/inception-bn.py), MXNet's
own ImageNet model: BatchNorm after every convolution, 31 of them 3x3."""
from .. import symbol as sym


def _conv_factory(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
                  name=None, suffix=''):
    conv = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad,
                           name='conv_%s%s' % (name, suffix))
    bn = sym.BatchNorm(data=conv, fix_gamma=False,
                       name='bn_%s%s' % (name, suffix))
    return sym.Activation(data=bn, act_type='relu',
                          name='relu_%s%s' % (name, suffix))


def _inception_a(data, n1, n3r, n3, nd3r, nd3, pool, proj, name):
    c1 = _conv_factory(data, n1, (1, 1), name=('%s_1x1' % name))
    c3 = _conv_factory(data, n3r, (1, 1), name=('%s_3x3' % name),
                       suffix='_reduce')
    c3 = _conv_factory(c3, n3, (3, 3), pad=(1, 1), name=('%s_3x3' % name))
    cd3 = _conv_factory(data, nd3r, (1, 1), name=('%s_double_3x3' % name),
                        suffix='_reduce')
    cd3 = _conv_factory(cd3, nd3, (3, 3), pad=(1, 1),
                        name=('%s_double_3x3_0' % name))
    cd3 = _conv_factory(cd3, nd3, (3, 3), pad=(1, 1),
                        name=('%s_double_3x3_1' % name))
    p = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                    pool_type=pool, name=('%s_pool_%s_pool' % (pool, name)))
    p = _conv_factory(p, proj, (1, 1), name=('%s_proj' % name))
    return sym.Concat(c1, c3, cd3, p, name='ch_concat_%s_chconcat' % name)


def _inception_b(data, n3r, n3, nd3r, nd3, name):
    c3 = _conv_factory(data, n3r, (1, 1), name=('%s_3x3' % name),
                       suffix='_reduce')
    c3 = _conv_factory(c3, n3, (3, 3), pad=(1, 1), stride=(2, 2),
                       name=('%s_3x3' % name))
    cd3 = _conv_factory(data, nd3r, (1, 1), name=('%s_double_3x3' % name),
                        suffix='_reduce')
    cd3 = _conv_factory(cd3, nd3, (3, 3), pad=(1, 1),
                        name=('%s_double_3x3_0' % name))
    cd3 = _conv_factory(cd3, nd3, (3, 3), pad=(1, 1), stride=(2, 2),
                        name=('%s_double_3x3_1' % name))
    p = sym.Pooling(data=data, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type='max', name=('max_pool_%s_pool' % name))
    return sym.Concat(c3, cd3, p, name='ch_concat_%s_chconcat' % name)


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable('data')
    body = _conv_factory(data, 64, (7, 7), stride=(2, 2), pad=(3, 3), name='1')
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                       pool_type='max', name='pool_1', pad=(1, 1))
    body = _conv_factory(body, 64, (1, 1), name='2_red')
    body = _conv_factory(body, 192, (3, 3), pad=(1, 1), name='2')
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                       pool_type='max', name='pool_2', pad=(1, 1))
    body = _inception_a(body, 64, 64, 64, 64, 96, 'avg', 32, '3a')
    body = _inception_a(body, 64, 64, 96, 64, 96, 'avg', 64, '3b')
    body = _inception_b(body, 128, 160, 64, 96, '3c')
    body = _inception_a(body, 224, 64, 96, 96, 128, 'avg', 128, '4a')
    body = _inception_a(body, 192, 96, 128, 96, 128, 'avg', 128, '4b')
    body = _inception_a(body, 160, 128, 160, 128, 160, 'avg', 128, '4c')
    body = _inception_a(body, 96, 128, 192, 160, 192, 'avg', 128, '4d')
    body = _inception_b(body, 128, 192, 192, 256, '4e')
    body = _inception_a(body, 352, 192, 320, 160, 224, 'avg', 128, '5a')
    body = _inception_a(body, 352, 192, 320, 192, 224, 'max', 128, '5b')
    pool = sym.Pooling(data=body, kernel=(7, 7), stride=(1, 1),
                       global_pool=True, pool_type='avg', name='global_pool')
    flat = sym.Flatten(data=pool, name='flatten')
    fc1 = sym.FullyConnected(data=flat, num_hidden=num_classes, name='fc1')
    return sym.SoftmaxOutput(data=fc1, name='softmax')
