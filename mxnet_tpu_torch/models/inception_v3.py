"""Inception-v3 (counterpart of ``mxnet_tpu/models/inception_v3.py``,
reference example/image-classification/symbols/inception-v3.py,
Szegedy et al. "Rethinking the Inception Architecture"). 299x299 input."""
from .. import symbol as sym


def _conv(data, num_filter, kernel=(1, 1), stride=(1, 1), pad=(0, 0),
          name=None, suffix=''):
    c = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True,
                        name='%s%s_conv2d' % (name, suffix))
    bn = sym.BatchNorm(data=c, eps=0.001, fix_gamma=True,
                       name='%s%s_batchnorm' % (name, suffix))
    return sym.Activation(data=bn, act_type='relu',
                          name='%s%s_relu' % (name, suffix))


def _pool(data, kernel, stride, pad, pool_type, name):
    return sym.Pooling(data=data, kernel=kernel, stride=stride, pad=pad,
                       pool_type=pool_type, name=name)


def _inception7a(data, n1, n5r, n5, n3r, n3, proj, name):
    t1 = _conv(data, n1, name=('%s_conv' % name))
    t5 = _conv(data, n5r, name=('%s_tower' % name), suffix='_conv')
    t5 = _conv(t5, n5, kernel=(5, 5), pad=(2, 2), name=('%s_tower' % name),
               suffix='_conv_1')
    t3 = _conv(data, n3r, name=('%s_tower_1' % name), suffix='_conv')
    t3 = _conv(t3, n3, kernel=(3, 3), pad=(1, 1), name=('%s_tower_1' % name),
               suffix='_conv_1')
    t3 = _conv(t3, n3, kernel=(3, 3), pad=(1, 1), name=('%s_tower_1' % name),
               suffix='_conv_2')
    p = _pool(data, (3, 3), (1, 1), (1, 1), 'avg',
              ('%s_pool_%s_pool' % ('avg', name)))
    cp = _conv(p, proj, name=('%s_tower_2' % name), suffix='_conv')
    return sym.Concat(t1, t5, t3, cp, name='ch_concat_%s_chconcat' % name)


def _inception7b(data, n3, nd3r, nd3, name):
    t3 = _conv(data, n3, kernel=(3, 3), pad=(0, 0), stride=(2, 2),
               name=('%s_conv' % name))
    td3 = _conv(data, nd3r, name=('%s_tower' % name), suffix='_conv')
    td3 = _conv(td3, nd3, kernel=(3, 3), pad=(1, 1),
                name=('%s_tower' % name), suffix='_conv_1')
    td3 = _conv(td3, nd3, kernel=(3, 3), pad=(0, 0), stride=(2, 2),
                name=('%s_tower' % name), suffix='_conv_2')
    p = _pool(data, (3, 3), (2, 2), (0, 0), 'max',
              ('max_pool_%s_pool' % name))
    return sym.Concat(t3, td3, p, name='ch_concat_%s_chconcat' % name)


def _inception7c(data, n1, n7r, n7, nd7r, nd7, proj, name):
    t1 = _conv(data, n1, name=('%s_conv' % name))
    t7 = _conv(data, n7r, name=('%s_tower' % name), suffix='_conv')
    t7 = _conv(t7, n7, kernel=(1, 7), pad=(0, 3), name=('%s_tower' % name),
               suffix='_conv_1')
    t7 = _conv(t7, n7, kernel=(7, 1), pad=(3, 0), name=('%s_tower' % name),
               suffix='_conv_2')
    td7 = _conv(data, nd7r, name=('%s_tower_1' % name), suffix='_conv')
    td7 = _conv(td7, nd7r, kernel=(7, 1), pad=(3, 0),
                name=('%s_tower_1' % name), suffix='_conv_1')
    td7 = _conv(td7, nd7r, kernel=(1, 7), pad=(0, 3),
                name=('%s_tower_1' % name), suffix='_conv_2')
    td7 = _conv(td7, nd7r, kernel=(7, 1), pad=(3, 0),
                name=('%s_tower_1' % name), suffix='_conv_3')
    td7 = _conv(td7, nd7, kernel=(1, 7), pad=(0, 3),
                name=('%s_tower_1' % name), suffix='_conv_4')
    p = _pool(data, (3, 3), (1, 1), (1, 1), 'avg',
              ('avg_pool_%s_pool' % name))
    cp = _conv(p, proj, name=('%s_tower_2' % name), suffix='_conv')
    return sym.Concat(t1, t7, td7, cp, name='ch_concat_%s_chconcat' % name)


def _inception7d(data, n3r, n3, n7r, n7, name):
    t3 = _conv(data, n3r, name=('%s_tower' % name), suffix='_conv')
    t3 = _conv(t3, n3, kernel=(3, 3), pad=(0, 0), stride=(2, 2),
               name=('%s_tower' % name), suffix='_conv_1')
    t7 = _conv(data, n7r, name=('%s_tower_1' % name), suffix='_conv')
    t7 = _conv(t7, n7r, kernel=(1, 7), pad=(0, 3),
               name=('%s_tower_1' % name), suffix='_conv_1')
    t7 = _conv(t7, n7r, kernel=(7, 1), pad=(3, 0),
               name=('%s_tower_1' % name), suffix='_conv_2')
    t7 = _conv(t7, n7, kernel=(3, 3), stride=(2, 2),
               name=('%s_tower_1' % name), suffix='_conv_3')
    p = _pool(data, (3, 3), (2, 2), (0, 0), 'max',
              ('max_pool_%s_pool' % name))
    return sym.Concat(t3, t7, p, name='ch_concat_%s_chconcat' % name)


def _inception7e(data, n1, n3r, n3, nd3r, nd3, pool, proj, name):
    t1 = _conv(data, n1, name=('%s_conv' % name))
    t3 = _conv(data, n3r, name=('%s_tower' % name), suffix='_conv')
    t3a = _conv(t3, n3, kernel=(1, 3), pad=(0, 1), name=('%s_tower' % name),
                suffix='_mixed_conv')
    t3b = _conv(t3, n3, kernel=(3, 1), pad=(1, 0), name=('%s_tower' % name),
                suffix='_mixed_conv_1')
    td3 = _conv(data, nd3r, name=('%s_tower_1' % name), suffix='_conv')
    td3 = _conv(td3, nd3, kernel=(3, 3), pad=(1, 1),
                name=('%s_tower_1' % name), suffix='_conv_1')
    td3a = _conv(td3, nd3, kernel=(1, 3), pad=(0, 1),
                 name=('%s_tower_1' % name), suffix='_mixed_conv')
    td3b = _conv(td3, nd3, kernel=(3, 1), pad=(1, 0),
                 name=('%s_tower_1' % name), suffix='_mixed_conv_1')
    p = _pool(data, (3, 3), (1, 1), (1, 1), pool,
              ('%s_pool_%s_pool' % (pool, name)))
    cp = _conv(p, proj, name=('%s_tower_2' % name), suffix='_conv')
    return sym.Concat(t1, t3a, t3b, td3a, td3b, cp,
                      name='ch_concat_%s_chconcat' % name)


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable('data')
    # stem
    body = _conv(data, 32, kernel=(3, 3), stride=(2, 2), name='conv')
    body = _conv(body, 32, kernel=(3, 3), name='conv_1')
    body = _conv(body, 64, kernel=(3, 3), pad=(1, 1), name='conv_2')
    body = _pool(body, (3, 3), (2, 2), (0, 0), 'max', 'pool')
    body = _conv(body, 80, kernel=(1, 1), name='conv_3')
    body = _conv(body, 192, kernel=(3, 3), name='conv_4')
    body = _pool(body, (3, 3), (2, 2), (0, 0), 'max', 'pool1')
    # stage 3
    body = _inception7a(body, 64, 48, 64, 64, 96, 32, 'mixed')
    body = _inception7a(body, 64, 48, 64, 64, 96, 64, 'mixed_1')
    body = _inception7a(body, 64, 48, 64, 64, 96, 64, 'mixed_2')
    body = _inception7b(body, 384, 64, 96, 'mixed_3')
    # stage 4
    body = _inception7c(body, 192, 128, 192, 128, 192, 192, 'mixed_4')
    body = _inception7c(body, 192, 160, 192, 160, 192, 192, 'mixed_5')
    body = _inception7c(body, 192, 160, 192, 160, 192, 192, 'mixed_6')
    body = _inception7c(body, 192, 192, 192, 192, 192, 192, 'mixed_7')
    body = _inception7d(body, 192, 320, 192, 192, 'mixed_8')
    # stage 5
    body = _inception7e(body, 320, 384, 384, 448, 384, 'avg', 192, 'mixed_9')
    body = _inception7e(body, 320, 384, 384, 448, 384, 'max', 192, 'mixed_10')
    pool = sym.Pooling(data=body, kernel=(8, 8), stride=(1, 1),
                       global_pool=True, pool_type='avg', name='global_pool')
    flat = sym.Flatten(data=pool, name='flatten')
    fc1 = sym.FullyConnected(data=flat, num_hidden=num_classes, name='fc1')
    return sym.SoftmaxOutput(data=fc1, name='softmax')
