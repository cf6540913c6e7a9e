"""Model zoo: symbolic network definitions, the counterpart of
``mxnet_tpu/models`` for the models the port can train so far.

Factory: ``get_symbol(name, num_classes=..., **kwargs)``.
"""
from . import mlp, transformer

_BUILDERS = {
    "mlp": mlp.get_symbol,
    "transformer-lm": transformer.get_symbol,
}


def get_symbol(name, **kwargs):
    key = name.lower()
    if key not in _BUILDERS:
        raise ValueError("unknown model %r; available: %s"
                         % (name, sorted(_BUILDERS)))
    return _BUILDERS[key](**kwargs)
