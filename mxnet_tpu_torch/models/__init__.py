"""Model zoo: symbolic network definitions, the counterpart of
``mxnet_tpu/models`` for the models the port can train so far.

Factory: ``get_symbol(name, num_classes=..., **kwargs)``.
"""
from . import lenet, lstm_lm, mlp, resnet, transformer

_BUILDERS = {
    "mlp": mlp.get_symbol,
    "lenet": lenet.get_symbol,
    "resnet": resnet.get_symbol,
    "resnet-18": lambda **kw: resnet.get_symbol(num_layers=18, **kw),
    "resnet-34": lambda **kw: resnet.get_symbol(num_layers=34, **kw),
    "resnet-50": lambda **kw: resnet.get_symbol(num_layers=50, **kw),
    "resnet-101": lambda **kw: resnet.get_symbol(num_layers=101, **kw),
    "resnet-152": lambda **kw: resnet.get_symbol(num_layers=152, **kw),
    "transformer-lm": transformer.get_symbol,
    "lstm-lm": lstm_lm.get_symbol,
}


def get_symbol(name, **kwargs):
    key = name.lower()
    if key not in _BUILDERS:
        raise ValueError("unknown model %r; available: %s"
                         % (name, sorted(_BUILDERS)))
    return _BUILDERS[key](**kwargs)
