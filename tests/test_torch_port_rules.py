"""Rules the PyTorch port keeps: it never imports JAX or the JAX package,
and its entry points never fall back to the CPU on their own."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import context, models
from mxnet_tpu_torch import ndarray as nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import Executor
from mxnet_tpu_torch.serving import generate as tgen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, names in os.walk(os.path.join(ROOT, "mxnet_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_never_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = [(os.path.relpath(p, ROOT), m) for p in files for m in _imports(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_package_never_imports_a_root_script():
    """The package stands alone: chip_smoke.py imports from it, never the
    other way round."""
    root_scripts = {n[:-3] for n in os.listdir(ROOT) if n.endswith(".py")}
    bad = [(os.path.relpath(p, ROOT), m) for p in _port_files()
           if os.path.dirname(p) != ROOT for m in _imports(p)
           if m.split(".")[0] in root_scripts]
    assert not bad, bad


def _port_modules():
    """Dotted names of every module of the package."""
    pkg = os.path.join(ROOT, "mxnet_tpu_torch")
    mods = []
    for path in _port_files():
        if not path.startswith(pkg + os.sep):
            continue
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__")
                    else rel)
    return mods


def test_import_leaves_jax_unloaded():
    mods = _port_modules()
    assert {"mxnet_tpu_torch.symbol", "mxnet_tpu_torch.executor",
            "mxnet_tpu_torch.optimizer",
            "mxnet_tpu_torch.ops.kernels.fused_update"} <= set(mods)
    code = ("import importlib, sys; "
            "[importlib.import_module(m) for m in %r]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)" % (mods,))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_without_device_raise_when_cuda_is_absent(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        context.default_device()
    params = {"embed_weight": np.zeros((4, 8), np.float32)}
    with pytest.raises(MXNetError, match="no CUDA device"):
        tgen.params_from_numpy(params)
    with pytest.raises(MXNetError, match="no CUDA device"):
        tgen.DecodeModel.from_arg_params(params, tgen.DecodeSpec(2))
    with pytest.raises(MXNetError, match="no CUDA device"):
        nd.array([1.0, 2.0])
    with pytest.raises(MXNetError, match="no CUDA device"):
        nd.zeros((2, 2))
    mlp = models.get_symbol("mlp", num_classes=3, hidden=(4,))
    with pytest.raises(MXNetError, match="no CUDA device"):
        mlp.simple_bind(data=(2, 5))
    exe = mlp.simple_bind("cpu", data=(2, 5))
    with pytest.raises(MXNetError, match="no CUDA device"):
        Executor(mlp, None, exe.arg_dict)
    # asking for the host explicitly is the way onto the CPU
    assert context.resolve_device("cpu") == torch.device("cpu")
    assert context.gpu(1) == torch.device("cuda", 1)
