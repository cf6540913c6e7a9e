"""Runtime analysis of the port: the compile witness
(:mod:`.compile_witness`), counterpart of the JAX package's
``analysis.compile_witness``."""
from . import compile_witness  # noqa: F401
