"""SSD detector on a reduced-VGG16 backbone (``ssd-vgg16``).

Counterpart of ``mxnet_tpu/models/ssd.py`` (the reference's example/ssd),
built from the contrib multibox ops (``ops/contrib.py``: MultiBoxPrior,
MultiBoxTarget, MultiBoxDetection). Every scale's class and location heads
are 3x3 convolutions whose outputs are flattened and concatenated once;
the anchors of each scale concatenate to one (1, A, 4) set, so matching
and NMS run over one static anchor set. At 300 x 300 the four scales are
18^2, 9^2, 5^2 and 3^2 positions of 4 anchors: 1,756 anchors.

``get_symbol(num_classes, mode='train')`` groups [cls_prob, loc_loss,
cls_target]; ``mode='detect'`` ends in MultiBoxDetection.
"""
from .. import symbol as sym


def _conv_act(data, name, num_filter, kernel=(3, 3), pad=(1, 1),
              stride=(1, 1)):
    c = sym.Convolution(data=data, kernel=kernel, pad=pad, stride=stride,
                        num_filter=num_filter, name=name)
    return sym.Activation(data=c, act_type="relu", name=name + "_relu")


def _backbone(data):
    """Reduced VGG16: conv1_1..conv5_3 (pool5 3×3/1), dilated-fc analogue
    conv6/conv7, then extra pyramid scales conv8/conv9/conv10."""
    feats = []
    cfg = [(2, 64), (2, 128), (3, 256), (3, 512)]
    for i, (n, f) in enumerate(cfg):
        for j in range(n):
            data = _conv_act(data, "conv%d_%d" % (i + 1, j + 1), f)
        data = sym.Pooling(data=data, pool_type="max", kernel=(2, 2),
                           stride=(2, 2), name="pool%d" % (i + 1))
    # conv4_3-equivalent scale (after pool4 here for static simplicity)
    feats.append(data)  # stride 16 feature
    for j in range(3):
        data = _conv_act(data, "conv5_%d" % (j + 1), 512)
    data = sym.Pooling(data=data, pool_type="max", kernel=(2, 2),
                       stride=(2, 2), name="pool5")
    data = _conv_act(data, "conv6", 1024)
    data = _conv_act(data, "conv7", 1024, kernel=(1, 1), pad=(0, 0))
    feats.append(data)  # stride 32
    data = _conv_act(data, "conv8_1", 256, kernel=(1, 1), pad=(0, 0))
    data = _conv_act(data, "conv8_2", 512, stride=(2, 2))
    feats.append(data)  # stride 64
    data = _conv_act(data, "conv9_1", 128, kernel=(1, 1), pad=(0, 0))
    data = _conv_act(data, "conv9_2", 256, stride=(2, 2))
    feats.append(data)  # stride 128
    return feats


_SIZES = [(0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619)]
_RATIOS = [(1.0, 2.0, 0.5)] * 4


def _multibox_layers(feats, num_classes):
    """Per-scale heads → concatenated (cls_preds, loc_preds, anchors)."""
    cls_list, loc_list, anchor_list = [], [], []
    num_cls = num_classes + 1  # + background
    for i, feat in enumerate(feats):
        na = len(_SIZES[i]) + len(_RATIOS[i]) - 1
        cls = sym.Convolution(data=feat, kernel=(3, 3), pad=(1, 1),
                              num_filter=na * num_cls,
                              name="cls_pred_%d" % i)
        # (B, A*C, H, W) -> (B, H*W*A, C): channel-last flatten keeps the
        # per-anchor class vector contiguous
        cls = sym.transpose(cls, axes=(0, 2, 3, 1))
        cls = sym.Reshape(data=cls, shape=(0, -1, num_cls))
        cls_list.append(cls)
        loc = sym.Convolution(data=feat, kernel=(3, 3), pad=(1, 1),
                              num_filter=na * 4, name="loc_pred_%d" % i)
        loc = sym.transpose(loc, axes=(0, 2, 3, 1))
        loc = sym.Reshape(data=loc, shape=(0, -1))
        loc_list.append(loc)
        anchor_list.append(sym.MultiBoxPrior(
            feat, sizes=_SIZES[i], ratios=_RATIOS[i], clip=True,
            name="anchors_%d" % i))
    cls_preds = sym.concat(*cls_list, dim=1, name="cls_preds")
    # MultiBox ops take (B, C, A) class predictions
    cls_preds = sym.transpose(cls_preds, axes=(0, 2, 1))
    loc_preds = sym.concat(*loc_list, dim=1, name="loc_preds")
    anchors = sym.concat(*anchor_list, dim=1, name="anchors")
    return cls_preds, loc_preds, anchors


def get_symbol(num_classes=20, mode="train", nms_threshold=0.5,
               nms_topk=400, **kwargs):
    data = sym.Variable("data")
    feats = _backbone(data)
    cls_preds, loc_preds, anchors = _multibox_layers(feats, num_classes)

    if mode == "detect":
        cls_prob = sym.softmax(cls_preds, axis=1, name="cls_prob")
        return sym.MultiBoxDetection(cls_prob, loc_preds, anchors,
                                     nms_threshold=nms_threshold,
                                     nms_topk=nms_topk, name="detection")

    label = sym.Variable("label")
    loc_target, loc_mask, cls_target = sym.MultiBoxTarget(
        anchors, label, cls_preds, overlap_threshold=0.5,
        ignore_label=-1.0, negative_mining_ratio=3.0, name="multibox_target")
    cls_prob = sym.SoftmaxOutput(data=cls_preds, label=cls_target,
                                 ignore_label=-1.0, use_ignore=True,
                                 multi_output=True,
                                 normalization="valid", name="cls_prob")
    loc_diff = sym._mul(loc_mask, sym._minus(loc_preds, loc_target))
    loc_loss = sym.MakeLoss(sym.smooth_l1(loc_diff, scalar=1.0),
                            grad_scale=1.0, normalization="valid",
                            name="loc_loss")
    cls_target_out = sym.BlockGrad(cls_target, name="cls_target")
    return sym.Group([cls_prob, loc_loss, cls_target_out])
