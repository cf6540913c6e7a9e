"""Class registries by name, for optimizers and initializers.

Counterpart of ``mxnet_tpu/registry.py`` (reference python/mxnet/
registry.py:15-141): ``get_register_func`` / ``get_alias_func`` /
``get_create_func`` attach a case-insensitive, string-keyed registry to a
base class, so ``create("sgd", momentum=0.9)``, ``create('["sgd", {...}]')``
and ``create(instance)`` all work.
"""
from __future__ import annotations

import json
import logging

from .base import MXNetError

_REGISTRY = {}  # base_class -> {lowercased name: klass}


def get_registry(base_class):
    """A copy of the name -> class mapping registered for ``base_class``."""
    return dict(_REGISTRY.get(base_class, {}))


def get_register_func(base_class, nickname):
    """A decorator registering subclasses of ``base_class``; registering a
    name again warns and overrides."""
    registry = _REGISTRY.setdefault(base_class, {})

    def register(klass, name=None):
        if not issubclass(klass, base_class):
            raise MXNetError("can only register subclasses of %s"
                             % base_class.__name__)
        name = (klass.__name__ if name is None else name).lower()
        if name in registry:
            logging.warning(
                "New %s %s.%s registered with name %s is overriding existing "
                "%s %s.%s", nickname, klass.__module__, klass.__name__, name,
                nickname, registry[name].__module__, registry[name].__name__)
        registry[name] = klass
        return klass

    register.__doc__ = "Register %s to the %s factory" % (nickname, nickname)
    return register


def get_alias_func(base_class, nickname):
    """A decorator registering a class under extra alias names."""
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for name in aliases:
                register(klass, name)
            return klass
        return reg

    alias.__doc__ = "Register %s under alias names" % nickname
    return alias


def get_create_func(base_class, nickname):
    """A ``create(spec, **kwargs)`` factory: an instance, a registered name,
    a JSON ``'["name", {...}]'`` / ``'{"name": ...}'`` string, or a dict."""
    registry = _REGISTRY.setdefault(base_class, {})

    def create(*args, **kwargs):
        if args:
            name, args = args[0], args[1:]
        else:
            name = kwargs.pop(nickname)
        if isinstance(name, base_class):
            if args or kwargs:
                raise MXNetError("%s is already an instance; extra arguments "
                                 "are invalid" % nickname)
            return name
        if isinstance(name, dict):
            return create(**name)
        if not isinstance(name, str):
            raise MXNetError("%s must be of string type" % nickname)
        if name.startswith("["):
            name, kw = json.loads(name)
            return create(name, **kw)
        if name.startswith("{"):
            return create(**json.loads(name))
        key = name.lower()
        if key not in registry:
            raise MXNetError("%s is not registered. Registered %ss: %s"
                             % (name, nickname, ", ".join(sorted(registry))))
        return registry[key](*args, **kwargs)

    create.__doc__ = "Create a %s instance from config" % nickname
    return create
