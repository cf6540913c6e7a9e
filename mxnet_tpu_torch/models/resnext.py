"""ResNeXt (counterpart of ``mxnet_tpu/models/resnext.py``,
reference example/image-classification/symbols/resnext.py —
Aggregated Residual Transformations): the ResNet bottleneck with the
middle 3x3 as a GROUPED convolution of cardinality ``num_group``; group
width scales the bottleneck channels by cardinality*bottle_width/64."""
from .. import symbol as sym


def _unit(data, num_filter, stride, dim_match, name, num_group, bn_mom,
          workspace):
    # reference resnext.py residual_unit (bottleneck form): channels are
    # 0.5*num_filter through the grouped middle conv
    mid = int(num_filter * 0.5)
    c1 = sym.Convolution(data=data, num_filter=mid, kernel=(1, 1),
                         stride=(1, 1), pad=(0, 0), no_bias=True,
                         workspace=workspace, name=name + '_conv1')
    b1 = sym.BatchNorm(data=c1, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                       name=name + '_bn1')
    a1 = sym.Activation(data=b1, act_type='relu', name=name + '_relu1')
    c2 = sym.Convolution(data=a1, num_filter=mid, num_group=num_group,
                         kernel=(3, 3), stride=stride, pad=(1, 1),
                         no_bias=True, workspace=workspace,
                         name=name + '_conv2')
    b2 = sym.BatchNorm(data=c2, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                       name=name + '_bn2')
    a2 = sym.Activation(data=b2, act_type='relu', name=name + '_relu2')
    c3 = sym.Convolution(data=a2, num_filter=num_filter, kernel=(1, 1),
                         stride=(1, 1), pad=(0, 0), no_bias=True,
                         workspace=workspace, name=name + '_conv3')
    b3 = sym.BatchNorm(data=c3, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                       name=name + '_bn3')
    if dim_match:
        shortcut = data
    else:
        sc = sym.Convolution(data=data, num_filter=num_filter,
                             kernel=(1, 1), stride=stride, no_bias=True,
                             workspace=workspace, name=name + '_sc')
        shortcut = sym.BatchNorm(data=sc, fix_gamma=False, eps=2e-5,
                                 momentum=bn_mom, name=name + '_sc_bn')
    return sym.Activation(data=b3 + shortcut, act_type='relu',
                          name=name + '_relu')


_DEPTH_CONFIG = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


def get_symbol(num_classes=1000, num_layers=50, num_group=32,
               image_shape=(3, 224, 224), bn_mom=0.9, workspace=256,
               **kwargs):
    if num_layers not in _DEPTH_CONFIG:
        raise ValueError("unsupported resnext depth %d" % num_layers)
    units = _DEPTH_CONFIG[num_layers]
    filter_list = [64, 256, 512, 1024, 2048]

    if image_shape[1] <= 32:
        raise ValueError(
            "resnext here is the ImageNet 4-stage configuration; the "
            "reference's CIFAR variant uses a different 3-stage layout "
            "(resnext.py num_stages=3) that is out of scope")
    data = sym.Variable(name='data')
    data = sym.BatchNorm(data=data, fix_gamma=True, eps=2e-5,
                         momentum=bn_mom, name='bn_data')
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
        body = _unit(body, filter_list[stage + 1], stride, False,
                     'stage%d_unit1' % (stage + 1), num_group, bn_mom,
                     workspace)
        for unit in range(units[stage] - 1):
            body = _unit(body, filter_list[stage + 1], (1, 1), True,
                         'stage%d_unit%d' % (stage + 1, unit + 2),
                         num_group, bn_mom, workspace)

    pool1 = sym.Pooling(data=body, global_pool=True, kernel=(7, 7),
                        pool_type='avg', name='pool1')
    flat = sym.Flatten(data=pool1)
    fc1 = sym.FullyConnected(data=flat, num_hidden=num_classes, name='fc1')
    return sym.SoftmaxOutput(data=fc1, name='softmax')
