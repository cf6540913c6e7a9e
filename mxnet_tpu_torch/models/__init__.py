"""Model zoo: symbolic network definitions, the counterpart of
``mxnet_tpu/models`` (reference example/image-classification/symbols,
example/rnn and example/ssd), every builder key of the JAX package's.

Each classifier's head is a SoftmaxOutput named ``softmax``, so it drops
into ``Module.fit`` unchanged; ``ssd-vgg16`` groups its class
probabilities, location loss and class targets (``models/ssd.py``).
Factory: ``get_symbol(name, num_classes=..., **kwargs)``.
"""
from . import (alexnet, googlenet, inception_bn, inception_resnet_v2,
               inception_v3, lenet, lstm_lm, mlp, resnet, resnext, ssd,
               transformer, vgg)

_BUILDERS = {
    "mlp": mlp.get_symbol,
    "lenet": lenet.get_symbol,
    "alexnet": alexnet.get_symbol,
    "vgg": vgg.get_symbol,
    "vgg16": lambda **kw: vgg.get_symbol(num_layers=16, **kw),
    "vgg19": lambda **kw: vgg.get_symbol(num_layers=19, **kw),
    "googlenet": googlenet.get_symbol,
    "inception-v1": googlenet.get_symbol,
    "inception-bn": inception_bn.get_symbol,
    "inception-v3": inception_v3.get_symbol,
    "inception-resnet-v2": inception_resnet_v2.get_symbol,
    "resnet": resnet.get_symbol,
    "resnet-18": lambda **kw: resnet.get_symbol(num_layers=18, **kw),
    "resnet-34": lambda **kw: resnet.get_symbol(num_layers=34, **kw),
    "resnet-50": lambda **kw: resnet.get_symbol(num_layers=50, **kw),
    "resnet-101": lambda **kw: resnet.get_symbol(num_layers=101, **kw),
    "resnet-152": lambda **kw: resnet.get_symbol(num_layers=152, **kw),
    "resnext": resnext.get_symbol,
    "resnext-50": lambda **kw: resnext.get_symbol(num_layers=50, **kw),
    "resnext-101": lambda **kw: resnext.get_symbol(num_layers=101, **kw),
    "resnext-152": lambda **kw: resnext.get_symbol(num_layers=152, **kw),
    "transformer-lm": transformer.get_symbol,
    "lstm-lm": lstm_lm.get_symbol,
    "ssd-vgg16": ssd.get_symbol,
}


def get_symbol(name, **kwargs):
    key = name.lower()
    if key not in _BUILDERS:
        raise ValueError("unknown model %r; available: %s"
                         % (name, sorted(_BUILDERS)))
    return _BUILDERS[key](**kwargs)
