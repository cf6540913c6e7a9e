"""Compile CUDA C at run time and launch it: ctypes bindings to NVRTC and
the CUDA driver API.

The reference MXNet's ``MXRtc`` (include/mxnet/mxrtc.h, src/common/
mxrtc.cc) used the same pair; in the JAX package ``pl.pallas_call`` +
``jit`` did this job (``mxnet_tpu/rtc.py:77``). Here:

- :func:`compile_cubin` runs ``nvrtcCreateProgram`` / ``nvrtcCompileProgram``
  with ``--gpu-architecture=sm_90a`` and ``-I$CUDA_HOME/include`` (for
  ``cuda_bf16.h``) and returns ``nvrtcGetCUBIN``'s image; a failed compile
  raises an :class:`MXNetError` carrying ``nvrtcGetProgramLog``;
- :func:`get_function` loads the image with ``cuModuleLoadData`` into the
  device's primary context (the one PyTorch's runtime uses) and finds the
  ``extern "C"`` entry with ``cuModuleGetFunction``;
- :func:`launch` runs ``cuLaunchKernel`` on PyTorch's current stream of the
  device, and raises on any ``CUresult`` but success.

``libnvrtc.so`` is found beside the ``nvcc`` that ``_build`` finds
(``$CUDA_HOME/lib64``), ``libcuda.so.1`` from the CUDA driver. Both load
at the first compile or launch, never at import. A thread that PyTorch's
runtime has not touched has no current context, so every call retains
the device's primary context and makes it current first.
"""
from __future__ import annotations

import ctypes
import glob
import os
import threading
import time
from typing import Dict, List, Sequence, Tuple

from ...base import MXNetError

ARCH = "sm_90a"
_PTR = ctypes.c_void_p
_SIZE = ctypes.c_size_t
_UINT = ctypes.c_uint
_INT = ctypes.c_int

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_primary: Dict[int, ctypes.c_void_p] = {}
_functions: Dict[Tuple[int, bytes, str], ctypes.c_void_p] = {}
_modules: List[ctypes.c_void_p] = []  # loaded modules stay for the process
#: NVRTC compiles this process has run (each key of each Rtc compiles once)
compiles = 0


def cuda_home() -> str:
    """The toolkit root of the ``nvcc`` that ``_build`` builds with."""
    from . import _build

    return os.path.dirname(os.path.dirname(os.path.realpath(
        _build.nvcc())))


def _nvrtc() -> ctypes.CDLL:
    lib = _libs.get("nvrtc")
    if lib is not None:
        return lib
    home = cuda_home()
    found = []
    for d in ("lib64", "lib", os.path.join("targets", "x86_64-linux",
                                            "lib")):
        found += sorted(glob.glob(os.path.join(home, d, "libnvrtc.so*")))
    if not found:
        raise MXNetError("libnvrtc.so not found under %s (lib64): mx.rtc "
                         "compiles CUDA C with NVRTC" % home)
    lib = ctypes.CDLL(found[0])
    sig = {"nvrtcCreateProgram": [ctypes.POINTER(_PTR), ctypes.c_char_p,
                                  ctypes.c_char_p, _INT, _PTR, _PTR],
           "nvrtcCompileProgram": [_PTR, _INT,
                                   ctypes.POINTER(ctypes.c_char_p)],
           "nvrtcGetProgramLogSize": [_PTR, ctypes.POINTER(_SIZE)],
           "nvrtcGetProgramLog": [_PTR, ctypes.c_char_p],
           "nvrtcGetCUBINSize": [_PTR, ctypes.POINTER(_SIZE)],
           "nvrtcGetCUBIN": [_PTR, ctypes.c_char_p],
           "nvrtcDestroyProgram": [ctypes.POINTER(_PTR)],
           "nvrtcVersion": [ctypes.POINTER(_INT), ctypes.POINTER(_INT)]}
    for name, argtypes in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _INT
    lib.nvrtcGetErrorString.argtypes = [_INT]
    lib.nvrtcGetErrorString.restype = ctypes.c_char_p
    _libs["nvrtc"] = lib
    return lib


def _cuda() -> ctypes.CDLL:
    lib = _libs.get("cuda")
    if lib is not None:
        return lib
    lib = ctypes.CDLL("libcuda.so.1")
    sig = {"cuInit": [_UINT],
           "cuDeviceGet": [ctypes.POINTER(_INT), _INT],
           "cuDevicePrimaryCtxRetain": [ctypes.POINTER(_PTR), _INT],
           "cuCtxGetCurrent": [ctypes.POINTER(_PTR)],
           "cuCtxSetCurrent": [_PTR],
           "cuModuleLoadData": [ctypes.POINTER(_PTR), _PTR],
           "cuModuleGetFunction": [ctypes.POINTER(_PTR), _PTR,
                                   ctypes.c_char_p],
           "cuLaunchKernel": [_PTR, _UINT, _UINT, _UINT, _UINT, _UINT,
                              _UINT, _UINT, _PTR, ctypes.POINTER(_PTR),
                              ctypes.POINTER(_PTR)],
           "cuGetErrorName": [_INT, ctypes.POINTER(ctypes.c_char_p)]}
    for name, argtypes in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _INT
    _libs["cuda"] = lib
    return lib


def _check_nvrtc(res: int, what: str):
    if res != 0:
        msg = _nvrtc().nvrtcGetErrorString(res)
        raise MXNetError("%s failed: %s (nvrtcResult %d)"
                         % (what, msg.decode() if msg else "?", res))


def _check_cu(res: int, what: str):
    if res != 0:
        name = ctypes.c_char_p()
        _cuda().cuGetErrorName(res, ctypes.byref(name))
        raise MXNetError("%s failed: %s (CUresult %d)"
                         % (what, name.value.decode() if name.value
                            else "?", res))


def nvrtc_version() -> Tuple[int, int]:
    major, minor = _INT(), _INT()
    _check_nvrtc(_nvrtc().nvrtcVersion(ctypes.byref(major),
                                       ctypes.byref(minor)), "nvrtcVersion")
    return major.value, minor.value


def compile_options() -> List[str]:
    return ["--gpu-architecture=%s" % ARCH,
            "-I%s" % os.path.join(cuda_home(), "include")]


def compile_cubin(src: str, name: str) -> Tuple[bytes, float]:
    """(CUBIN image, compile ms) of CUDA C ``src`` for sm_90a. A failed
    compile raises an MXNetError carrying NVRTC's log."""
    global compiles
    lib = _nvrtc()
    prog = _PTR()
    _check_nvrtc(lib.nvrtcCreateProgram(ctypes.byref(prog), src.encode(),
                                        ("%s.cu" % name).encode(), 0, None,
                                        None), "nvrtcCreateProgram")
    try:
        opts = [o.encode() for o in compile_options()]
        arr = (ctypes.c_char_p * len(opts))(*opts)
        t0 = time.perf_counter()
        res = lib.nvrtcCompileProgram(prog, len(opts), arr)
        ms = (time.perf_counter() - t0) * 1e3
        size = _SIZE()
        _check_nvrtc(lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size)),
                     "nvrtcGetProgramLogSize")
        log = ctypes.create_string_buffer(max(size.value, 1))
        _check_nvrtc(lib.nvrtcGetProgramLog(prog, log), "nvrtcGetProgramLog")
        if res != 0:
            raise MXNetError(
                "mx.rtc: NVRTC could not compile %s (%s):\n%s\n--- source "
                "---\n%s" % (name, lib.nvrtcGetErrorString(res).decode(),
                             log.value.decode(errors="replace"), src))
        _check_nvrtc(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        image = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib.nvrtcGetCUBIN(prog, image), "nvrtcGetCUBIN")
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))
    with _lock:
        compiles += 1
    return image.raw, ms


def _make_current(device_index: int):
    """Make the device's primary context current on this thread."""
    lib = _cuda()
    ctx = _primary.get(device_index)
    if ctx is None:
        with _lock:
            ctx = _primary.get(device_index)
            if ctx is None:
                _check_cu(lib.cuInit(0), "cuInit")
                dev = _INT()
                _check_cu(lib.cuDeviceGet(ctypes.byref(dev), device_index),
                          "cuDeviceGet")
                ctx = _PTR()
                _check_cu(lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx),
                                                       dev.value),
                          "cuDevicePrimaryCtxRetain")
                _primary[device_index] = ctx
    cur = _PTR()
    _check_cu(lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value != ctx.value:
        _check_cu(lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


def get_function(device_index: int, image: bytes, name: str):
    """The CUfunction ``name`` of CUBIN ``image``, loaded once per device."""
    key = (device_index, image, name)
    fn = _functions.get(key)
    if fn is not None:
        return fn
    _make_current(device_index)
    lib = _cuda()
    with _lock:
        fn = _functions.get(key)
        if fn is None:
            module = _PTR()
            buf = ctypes.create_string_buffer(image, len(image))
            _check_cu(lib.cuModuleLoadData(ctypes.byref(module), buf),
                      "cuModuleLoadData")
            _modules.append(module)
            fn = _PTR()
            _check_cu(lib.cuModuleGetFunction(ctypes.byref(fn), module,
                                              name.encode()),
                      "cuModuleGetFunction(%s)" % name)
            _functions[key] = fn
    return fn


def launch(fn, device_index: int, grid: Sequence[int], block: Sequence[int],
           pointers: Sequence[int], stream: int):
    """``cuLaunchKernel`` of ``fn`` with one pointer argument per entry of
    ``pointers`` on ``stream``; raises unless the launch was accepted."""
    _make_current(device_index)
    # cuLaunchKernel wants a void** of pointers to each argument's value;
    # ``args`` keeps the values alive over the call
    args = [_PTR(p) for p in pointers]
    params = (_PTR * max(len(args), 1))(
        *[ctypes.addressof(a) for a in args])
    _check_cu(_cuda().cuLaunchKernel(
        fn, grid[0], grid[1], grid[2], block[0], block[1], block[2], 0,
        _PTR(stream), params, None), "cuLaunchKernel")
