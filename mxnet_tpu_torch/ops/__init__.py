"""Operators of the port: plain PyTorch math registered by name
(``registry``), and the hand-written kernels (``ops/kernels``) that
replace the reference's Pallas kernels. Importing the package fills the
registry that ``ndarray`` and ``symbol`` generate their namespaces from."""
from . import (attention, broadcast_reduce, custom, elemwise, init_random,
               matrix, nn, optimizer_ops, rnn_fused, shape_rules)
from .registry import OP_REGISTRY, OpContext, OpDef, defop, get_op

shape_rules.install()

__all__ = ["OP_REGISTRY", "OpContext", "OpDef", "attention",
           "broadcast_reduce", "custom", "defop", "elemwise", "get_op", "init_random",
           "matrix", "nn", "optimizer_ops", "rnn_fused", "shape_rules"]
