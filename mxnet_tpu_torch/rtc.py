"""Runtime-compiled user kernels (``mx.rtc``).

Counterpart of ``mxnet_tpu/rtc.py``, which compiles user **Pallas** source
at run time (``Rtc._get_compiled``, its ``pl.pallas_call`` at ``:86``).
The port goes back to what the reference MXNet's ``MXRtc`` did
(include/mxnet/mxrtc.h, src/common/mxrtc.cc): user **CUDA C** compiled by
NVRTC for sm_90a and launched with the grid and block the caller gives.

    rtc = mx.rtc.create("axpy", ["x", "y"], ["out"], '''
        int i = blockIdx.x * blockDim.x + threadIdx.x;
        if (i < 128) out[i] = 2.0f * x[i] + y[i];
    ''')
    rtc.push([x, y], [out], grid_dims=(1,), block_dims=(128,))

Modes:

- ``"cuda"`` (the default; the JAX package's ``"pallas"``): ``src`` is a
  kernel body, as in the reference. The port wraps it as
  ``extern "C" __global__ void <name>(const T* <in>..., T* <out>...)``,
  ``T`` from each tensor's type (:data:`CUDA_TYPES`), compiles it once per
  signature (types and device; :meth:`Rtc.source` is the text) and launches
  it on PyTorch's current stream with ``grid_dims`` / ``block_dims``
  (required, 1 to 3 entries). Inputs are made contiguous; outputs must be
  contiguous CUDA tensors on the inputs' device and are written in place. A
  CPU tensor raises: the kernel never falls back. Each launch adds one to
  :attr:`Rtc.launches`.
- ``"torch"`` (the JAX package's ``"jax"``): ``src`` defines
  ``fn(*tensors)`` with ``torch`` in its namespace, returning the outputs,
  which are copied into ``outs``. This is a kernel's plain version, and
  runs on any device.

:func:`create` caches an :class:`Rtc` by ``sha1(name|mode|src)``, as the
reference caches by source (mxrtc.h:26-40).
"""
from __future__ import annotations

import hashlib
import textwrap
from typing import Dict, Sequence, Tuple

import torch

from .base import MXNetError
from .ndarray import NDArray
from .ops.kernels._launches import counted

MODES = ("cuda", "torch")
#: tensor type -> the CUDA C type of its kernel parameter
CUDA_TYPES = {torch.float32: "float", torch.float64: "double",
              torch.bfloat16: "__nv_bfloat16", torch.int32: "int",
              torch.int64: "long long"}

_CACHE: Dict[str, "Rtc"] = {}


def _dims(dims, what) -> Tuple[int, int, int]:
    """A launch dimension as a 3-tuple of positive ints."""
    if dims is None:
        raise MXNetError("rtc push in cuda mode needs %s (1 to 3 positive "
                         "ints)" % what)
    if isinstance(dims, int):
        dims = (dims,)
    dims = tuple(dims)
    if not 1 <= len(dims) <= 3 or not all(
            isinstance(d, int) and d > 0 for d in dims):
        raise MXNetError("rtc %s must be 1 to 3 positive ints, got %r"
                         % (what, dims))
    return dims + (1,) * (3 - len(dims))


class Rtc:
    """A runtime-compiled kernel (reference python/mxnet/rtc.py ``Rtc``).

    ``input_names`` / ``output_names`` name the kernel's parameters (cuda
    mode) and fix how many arrays :meth:`push` takes."""

    def __init__(self, name: str, input_names: Sequence[str],
                 output_names: Sequence[str], src: str, mode: str = "cuda"):
        if mode in ("pallas", "jax"):
            raise MXNetError("rtc mode %r is the JAX package's; the port's "
                             "modes are %s ('cuda' for CUDA C kernels, "
                             "'torch' for plain PyTorch)" % (mode, MODES))
        if mode not in MODES:
            raise MXNetError("rtc mode must be one of %s, not %r"
                             % (MODES, mode))
        self.name = name
        self.input_names = list(input_names)
        self.output_names = list(output_names)
        self.src = textwrap.dedent(src)
        self.mode = mode
        #: kernel launches (cuda mode) since the count was last reset
        counted(self)
        #: signature key -> NVRTC compile ms, one entry per compile
        self.compile_ms: Dict[Tuple, float] = {}
        self._images: Dict[Tuple, bytes] = {}
        if mode == "cuda":
            for n in [name] + self.input_names + self.output_names:
                if not n.isidentifier():
                    raise MXNetError("rtc: %r is not a C identifier" % n)
            return
        ns: Dict = {"torch": torch}
        try:
            exec(compile(self.src, "<mx.rtc:%s>" % name, "exec"), ns)
        except Exception as e:  # the user's source: surface any failure
            raise MXNetError("rtc source failed to compile: %s" % e) from e
        if not callable(ns.get("fn")):
            raise MXNetError("rtc source in torch mode must define a "
                             "function named 'fn'")
        self._fn = ns["fn"]

    def source(self, in_dtypes: Sequence[torch.dtype],
               out_dtypes: Sequence[torch.dtype]) -> str:
        """The CUDA C this kernel compiles to for the given tensor types:
        the body wrapped in its ``extern "C" __global__`` signature."""
        params = []
        for names, dtypes, const in ((self.input_names, in_dtypes, True),
                                     (self.output_names, out_dtypes, False)):
            for n, d in zip(names, dtypes):
                if d not in CUDA_TYPES:
                    raise MXNetError("rtc %s: no CUDA type for %s (%s)"
                                     % (self.name, n, d))
                params.append("%s%s* %s" % (
                    "const " if const else "", CUDA_TYPES[d], n))
        head = ("#include <cuda_bf16.h>\n"
                if torch.bfloat16 in tuple(in_dtypes) + tuple(out_dtypes)
                else "")
        return '%sextern "C" __global__ void %s(%s) {\n%s\n}\n' % (
            head, self.name, ", ".join(params), self.src)

    def _function(self, device: torch.device, in_dtypes, out_dtypes):
        """The loaded kernel for this signature, compiled at first use."""
        from .ops.kernels import rtc_driver

        key = (tuple(in_dtypes), tuple(out_dtypes))
        image = self._images.get(key)
        if image is None:
            image, ms = rtc_driver.compile_cubin(
                self.source(in_dtypes, out_dtypes), self.name)
            self._images[key] = image
            self.compile_ms[key] = ms
        return rtc_driver.get_function(device.index, image, self.name)

    def push(self, ins: Sequence[NDArray], outs: Sequence[NDArray],
             grid_dims=None, block_dims=None):
        """Run the kernel on ``ins``, writing ``outs`` in place (reference
        ``Rtc.push``); returns ``outs``."""
        if len(ins) != len(self.input_names):
            raise MXNetError("%s expects %d inputs, got %d"
                             % (self.name, len(self.input_names), len(ins)))
        if len(outs) != len(self.output_names):
            raise MXNetError("%s expects %d outputs, got %d"
                             % (self.name, len(self.output_names),
                                len(outs)))
        if self.mode == "torch":
            return self._push_torch(ins, outs)
        grid, block = _dims(grid_dims, "grid_dims"), _dims(block_dims,
                                                          "block_dims")
        in_t = [x._data.detach().contiguous() for x in ins]
        out_t = [o._data for o in outs]
        device = in_t[0].device if in_t else out_t[0].device
        for t in in_t + out_t:
            if t.device.type != "cuda":
                raise MXNetError("rtc %s runs CUDA kernels: a tensor lies on "
                                 "%s (use mode='torch' for the host)"
                                 % (self.name, t.device))
            if t.device != device:
                raise MXNetError("rtc %s: tensors on %s and %s"
                                 % (self.name, device, t.device))
        for n, t in zip(self.output_names, out_t):
            if not t.is_contiguous():
                raise MXNetError("rtc %s: output %s must be contiguous"
                                 % (self.name, n))
        from .ops.kernels import rtc_driver

        with torch.cuda.device(device):
            fn = self._function(device, [t.dtype for t in in_t],
                                [t.dtype for t in out_t])
            rtc_driver.launch(fn, device.index, grid, block,
                              [t.data_ptr() for t in in_t + out_t],
                              torch.cuda.current_stream(device).cuda_stream)
        self.launches += 1
        return outs

    def _push_torch(self, ins, outs):
        results = self._fn(*[x._data.detach() for x in ins])
        if isinstance(results, torch.Tensor):
            results = [results]
        results = list(results)
        if len(results) != len(outs):
            raise MXNetError("rtc %s: fn returned %d outputs, want %d"
                             % (self.name, len(results), len(outs)))
        with torch.no_grad():
            for o, r in zip(outs, results):
                o._data.copy_(r)
        return outs


def create(name: str, input_names, output_names, src: str,
           mode: str = "cuda") -> Rtc:
    """The :class:`Rtc` of this name, mode and source, made at the first
    call and cached (reference MXRtcCreate + its source cache)."""
    key = hashlib.sha1(("%s|%s|%s" % (name, mode, src)).encode()).hexdigest()
    rtc = _CACHE.get(key)
    if rtc is None:
        rtc = _CACHE[key] = Rtc(name, input_names, output_names, src, mode)
    return rtc

