"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so csrc/<name>.cu

Libraries land in ``mxnet_tpu_torch/_build/`` at first use, keyed by a hash
of the flags, the source and the ``csrc`` headers it includes, so an edited
source or header rebuilds the libraries that read it and no others. :func:`build_all` starts one ``nvcc`` per source at once.
A missing ``nvcc`` or a failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

from ...base import MXNetError

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}
#: name -> nvcc/ptxas output of the build made by this process (registers,
#: shared memory and spills per kernel), for the record
build_log: Dict[str, str] = {}


def nvcc() -> str:
    """Path of ``nvcc`` (PATH first, then ``$CUDA_HOME/bin``)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise MXNetError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA "
            "kernels are built from source at first use")
    return path


def sources() -> List[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def inputs(name: str) -> List[str]:
    """``name``'s source and the ``csrc`` headers it includes, directly or
    through another header, sorted."""
    todo, seen = [name + ".cu"], set()
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        with open(os.path.join(CSRC, f), "rb") as fh:
            todo += [i.decode() for i in _INCLUDE.findall(fh.read())
                     if os.path.exists(os.path.join(CSRC, i.decode()))]
    return sorted(seen)


def lib_path(name: str) -> str:
    """Where ``name``'s library lives for the current inputs and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in inputs(name):
        h.update(f.encode())
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, h.hexdigest()[:16]))


def _start(name: str, out: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.tmp%d" % (out, os.getpid())
    return subprocess.Popen(
        [nvcc()] + NVCC_FLAGS + ["-o", tmp, os.path.join(CSRC, name + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: str, proc: subprocess.Popen):
    log, _ = proc.communicate()
    build_log[name] = log
    tmp = "%s.tmp%d" % (out, os.getpid())
    if proc.returncode != 0:
        raise MXNetError("nvcc failed for %s.cu (exit %d):\n%s"
                         % (name, proc.returncode, log))
    with open(out + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def log_of(name: str) -> str:
    """The nvcc/ptxas output of the build of ``name``'s current library,
    kept beside it (this process's build, or an earlier one's)."""
    if name in build_log:
        return build_log[name]
    with open(lib_path(name) + ".log") as f:
        return f.read()


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Build every kernel not yet built (one nvcc each, all started
    together); returns name -> library path."""
    names = sources() if names is None else names
    with _lock:
        paths = {n: lib_path(n) for n in names}
        todo = [n for n in names if not os.path.exists(paths[n])]
        procs = [(n, _start(n, paths[n])) for n in todo]
        try:
            for n, p in procs:
                _finish(n, paths[n], p)
        finally:
            for _n, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = build_all([name])[name]
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]


def kernel(name: str, symbol: str, argtypes) -> object:
    """The C entry point ``symbol`` of kernel ``name``'s library, typed
    with ``argtypes`` and returning an int (a cudaError_t); built and
    loaded at first use."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn
