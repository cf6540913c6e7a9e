"""ResNet v2 (pre-activation), the model of bench.py's headline record.

Counterpart of ``mxnet_tpu/models/resnet.py`` (reference
example/image-classification/symbols/resnet.py, He et al. "Identity
Mappings in Deep Residual Networks"), with the same node and parameter
names. Depths 18/34 use basic blocks, 50/101/152 bottlenecks; images of
height <= 32 get the CIFAR stem (one 3x3 conv), larger ones the ImageNet
stem (7x7/2 conv, BN, ReLU, 3x3/2 max pool). f32 only: the reference's
``dtype`` casts wait for the bf16-compute slice.
"""
from .. import symbol as sym
from ..base import MXNetError


def _resunit(data, num_filter, stride, dim_match, name, bottle_neck,
             bn_mom=0.9, workspace=256):
    """One pre-activation residual unit."""
    def bn(x, suffix):
        return sym.BatchNorm(data=x, fix_gamma=False, eps=2e-5,
                             momentum=bn_mom, name=name + suffix)

    def relu(x, suffix):
        return sym.Activation(data=x, act_type='relu', name=name + suffix)

    def conv(x, nf, kernel, stride_, pad, suffix):
        return sym.Convolution(data=x, num_filter=nf, kernel=kernel,
                               stride=stride_, pad=pad, no_bias=True,
                               workspace=workspace, name=name + suffix)

    act1 = relu(bn(data, '_bn1'), '_relu1')
    if bottle_neck:
        conv1 = conv(act1, num_filter // 4, (1, 1), (1, 1), (0, 0), '_conv1')
        act2 = relu(bn(conv1, '_bn2'), '_relu2')
        conv2 = conv(act2, num_filter // 4, (3, 3), stride, (1, 1), '_conv2')
        act3 = relu(bn(conv2, '_bn3'), '_relu3')
        body = conv(act3, num_filter, (1, 1), (1, 1), (0, 0), '_conv3')
    else:
        conv1 = conv(act1, num_filter, (3, 3), stride, (1, 1), '_conv1')
        act2 = relu(bn(conv1, '_bn2'), '_relu2')
        body = conv(act2, num_filter, (3, 3), (1, 1), (1, 1), '_conv2')
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(data=act1, num_filter=num_filter,
                                   kernel=(1, 1), stride=stride, no_bias=True,
                                   workspace=workspace, name=name + '_sc')
    return body + shortcut


_DEPTH_CONFIG = {
    18: ([2, 2, 2, 2], False),
    34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True),
    101: ([3, 4, 23, 3], True),
    152: ([3, 8, 36, 3], True),
}


def get_symbol(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
               bn_mom=0.9, workspace=256, dtype='float32'):
    if num_layers not in _DEPTH_CONFIG:
        raise ValueError("unsupported resnet depth %d" % num_layers)
    if dtype != 'float32':
        raise MXNetError("resnet dtype %r is not ported (float32 only)"
                         % dtype)
    units, bottle_neck = _DEPTH_CONFIG[num_layers]
    filter_list = ([64, 256, 512, 1024, 2048] if bottle_neck
                   else [64, 64, 128, 256, 512])

    data = sym.Variable(name='data')
    data = sym.BatchNorm(data=data, fix_gamma=True, eps=2e-5,
                         momentum=bn_mom, name='bn_data')
    if image_shape[1] <= 32:  # CIFAR-style stem
        body = sym.Convolution(data=data, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, workspace=workspace, name='conv0')
    else:  # ImageNet stem
        body = sym.Convolution(data=data, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, workspace=workspace, name='conv0')
        body = sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5,
                             momentum=bn_mom, name='bn0')
        body = sym.Activation(data=body, act_type='relu', name='relu0')
        body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                           pad=(1, 1), pool_type='max', name='pool0')

    for stage in range(4):
        stride = (1, 1) if stage == 0 else (2, 2)
        body = _resunit(body, filter_list[stage + 1], stride, False,
                        'stage%d_unit1' % (stage + 1), bottle_neck,
                        bn_mom, workspace)
        for unit in range(units[stage] - 1):
            body = _resunit(body, filter_list[stage + 1], (1, 1), True,
                            'stage%d_unit%d' % (stage + 1, unit + 2),
                            bottle_neck, bn_mom, workspace)

    bn1 = sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5,
                        momentum=bn_mom, name='bn1')
    relu1 = sym.Activation(data=bn1, act_type='relu', name='relu1')
    pool1 = sym.Pooling(data=relu1, global_pool=True, kernel=(7, 7),
                        pool_type='avg', name='pool1')
    flat = sym.Flatten(data=pool1)
    fc1 = sym.FullyConnected(data=flat, num_hidden=num_classes, name='fc1')
    return sym.SoftmaxOutput(data=fc1, name='softmax')
