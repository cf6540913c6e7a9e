"""Deployment-only predictor (mx.predict).

Counterpart of ``mxnet_tpu/predict.py`` (the reference's prediction C API,
``c_predict_api.h``): :class:`Predictor` loads a symbol JSON and a param
blob (or dicts), binds an inference-only forward at fixed input shapes
(``is_train=False``, no gradients, no aux updates) and exposes
``set_input`` / ``forward`` / ``get_output`` / ``reshape``.

The reference compiles one XLA program a bound shape. The counterpart
here is **one CUDA graph a bound shape**: on a card, binding runs the
forward twice on a side stream (lazy initialization, cuBLAS workspaces),
captures it once over static input and output buffers, and every
``forward`` copies its inputs into those buffers, replays the graph and
copies the outputs out, all on the predictor's own stream and under its
run lock (a graph is not re-entrant, and a replay overwrites its static
outputs). Captures run one at a time in the process and in
``thread_local`` mode, so another thread's synchronizing calls (a
replica's ``.cpu()``, a bind on another replica) never break one.
``MXNET_CUDA_GRAPH=0`` at bind time runs the forward eagerly; on the CPU
it always runs eagerly.

:func:`compile_count` counts binds built from the symbol (one a
``Predictor`` or ``reshape``): the number the serving bucket cache's "no
more programs than buckets" contract is held to.

With the persistent program cache on (``progcache``: ``MXNET_PROGCACHE_DIR``
or ``MXNET_PROGCACHE=1``) a bind looks its program up by key (the model's
fingerprint, which hashes the weights' bytes, the input signature, the
device and the runtime). On a miss it builds the forward from the symbol,
traces it with ``torch.export`` (weights, aux states and bound zeros are
program inputs, so the payload is the graph alone; the flash forward is
the custom op ``mxtt::flash_attention_fwd``, so the saved program still
launches the hand-written kernel) and stores it; on a hit it loads the
exported program with no symbol build, no shape inference and no trace
(:func:`disk_load_count` counts these). Either way the bind then runs that
program, captured as a CUDA graph on a card. An unusable entry is the
cache's counted fallback to a fresh build, with the same outputs.
``export`` / ``ExportedPredictor`` (the reference's StableHLO artifact)
are not ported.
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional

import torch

from . import ndarray as nd
from . import progcache
from . import symbol as sym_mod
from .analysis import compile_witness as _witness
from .base import MXNetError
from .context import resolve_device
from .ndarray import NDArray, _as_torch_dtype
from .ops.kernels import _launches

#: forward calls on a side stream before the capture, as the executor's
CAPTURE_WARMUP = 2

_count_lock = threading.Lock()
_COMPILE_COUNT = 0
_DISK_LOAD_COUNT = 0


def compile_count() -> int:
    """Predictor binds built from the symbol in this process (float and
    quantized)."""
    with _count_lock:
        return _COMPILE_COUNT


def disk_load_count() -> int:
    """Predictor programs loaded from the program cache in this process
    (float and quantized)."""
    with _count_lock:
        return _DISK_LOAD_COUNT


class _Forward(torch.nn.Module):
    """The bound forward as a module over (raw weights, aux states, bound
    zeros, inputs), the shape ``torch.export`` traces."""

    def __init__(self, predictor):
        super().__init__()
        self._p = predictor

    def forward(self, raw, aux, zeros, inputs):
        p = self._p
        args = p._widen(raw)
        args.update(zeros)
        args.update(inputs)
        outs, _ = p._eval(args, aux, False)
        return tuple(outs)


def _load_program(payload: bytes, meta: Dict):
    """A saved program back as a callable; raises on anything unusable."""
    import io

    from .ops.kernels import flash_attention  # noqa: F401  the custom op

    ep = torch.export.load(io.BytesIO(payload))
    return ep.module(), meta


def _use_graph() -> bool:
    return os.environ.get("MXNET_CUDA_GRAPH", "1") != "0"


def _as_tensor(value) -> torch.Tensor:
    """A tensor of ``value``: an NDArray's or a tensor as it is, anything
    else copied (the caller may reuse its array after ``set_input``)."""
    if isinstance(value, NDArray):
        return value._data
    if isinstance(value, torch.Tensor):
        return value
    return nd.array(value, ctx="cpu")._data


class Predictor:
    """Inference-only executor (reference PredictorHandle)."""

    def __init__(self, symbol_json: str, params, input_shapes: Dict[str, tuple],
                 dtype="float32", device=None):
        """``symbol_json``: JSON string or path. ``params``: path to a
        ``.params`` file or a dict of name -> array (``arg:`` / ``aux:``
        prefixed or bare names, like MXPredCreate). ``device``: where the
        weights live and the forward runs (default the card; ``"cpu"``
        the host)."""
        self._device = resolve_device(device)
        if os.path.exists(symbol_json):
            self._symbol = sym_mod.load(symbol_json)
        else:
            self._symbol = sym_mod.load_json(symbol_json)
        loaded = nd.load(params) if isinstance(params, str) else dict(params)
        arg_params, aux_params = {}, {}
        for k, v in loaded.items():
            t = _as_tensor(v).to(self._device)
            if k.startswith("arg:"):
                arg_params[k[4:]] = t
            elif k.startswith("aux:"):
                aux_params[k[4:]] = t
            else:
                arg_params[k] = t
        self._input_names = list(input_shapes)
        self._input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        self._dtype = dtype
        arg_names = self._symbol.list_arguments()
        aux_names = self._symbol.list_auxiliary_states()
        # label-style arguments (SoftmaxOutput's label) are dead at
        # inference: bound to zeros of the inferred shape, per bind
        self._zero_bound = [n for n in arg_names if n not in arg_params
                            and n not in self._input_shapes]
        self._arg_params = {n: NDArray(arg_params[n]) for n in arg_names
                            if n in arg_params}
        self._aux_params = {n: NDArray(aux_params[n]) for n in aux_names
                            if n in aux_params}
        self._init_run_state()
        self._compile()

    def _init_run_state(self):
        self._inputs: Dict[str, Optional[NDArray]] = {
            n: None for n in self._input_shapes}
        self._outputs: List[NDArray] = []
        # a graph is not re-entrant and a replay overwrites its static
        # outputs: copy-in, replay and copy-out hold this lock
        self._run_lock = threading.RLock()

    # --- binding ----------------------------------------------------------
    def _bind_zeros(self) -> Dict[str, torch.Tensor]:
        if not self._zero_bound:
            return {}
        shapes, _, _ = self._symbol.infer_shape(**self._input_shapes)
        inferred = dict(zip(self._symbol.list_arguments(), shapes))
        out = {}
        for n in self._zero_bound:
            logging.getLogger("mxnet_tpu_torch").debug(
                "predictor: arg %r not in params; binding zeros %s",
                n, inferred[n])
            out[n] = torch.zeros(inferred[n], device=self._device,
                                 dtype=_as_torch_dtype(self._dtype))
        return out

    def _raw_params(self) -> Dict[str, object]:
        """The weights as the predictor holds them (a quantized predictor's
        ``(q, scale)`` pairs): the program's first input."""
        return {n: a._data for n, a in self._arg_params.items()}

    def _widen(self, raw) -> Dict[str, torch.Tensor]:
        """The weights the forward reads, from :meth:`_raw_params` (a
        quantized predictor widens them here, inside the forward)."""
        return dict(raw)

    def _param_values(self) -> Dict[str, torch.Tensor]:
        return self._widen(self._raw_params())

    def _run(self, inputs: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        aux = {n: a._data for n, a in self._aux_params.items()}
        if self._program is not None:
            return list(self._program(self._raw_params(), aux,
                                      dict(self._zeros), dict(inputs)))
        args = self._param_values()
        args.update(self._zeros)
        args.update(inputs)
        outs, _ = self._eval(args, aux, False)
        return list(outs)

    def _cache_key(self) -> Optional[str]:
        """The program cache's key of this bind (None with the cache
        off)."""
        if not progcache.enabled():
            return None
        fp = getattr(self, "_progcache_model_fp", None)
        if fp is None:
            fp = progcache.model_fingerprint(
                self._symbol, self._arg_params, self._aux_params)
            self._progcache_model_fp = fp
        return progcache.predictor_key(
            fp, self._input_names, self._input_shapes, self._dtype,
            self._device, extra=self._cache_extra())

    def _cache_extra(self) -> str:
        return ""

    _cache_kind = "predictor"

    def _export(self) -> bytes:
        """The forward traced with ``torch.export`` and saved: the
        program-cache payload."""
        import io

        dt = _as_torch_dtype(self._dtype)
        inputs = {n: torch.zeros(self._input_shapes[n], dtype=dt,
                                 device=self._device)
                  for n in self._input_names}
        aux = {n: a._data for n, a in self._aux_params.items()}
        with torch.no_grad():
            ep = torch.export.export(
                _Forward(self), (self._raw_params(), aux, dict(self._zeros),
                                 inputs), strict=False)
        # the example inputs hold every weight: saved, they would make the
        # payload the model's size
        ep.example_inputs = None
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        return buf.getvalue()

    def _compile(self):
        global _COMPILE_COUNT, _DISK_LOAD_COUNT
        self._graph = None
        self._stream = None
        self._program = None
        self.warmup_calls = self.captures = self.replays = 0
        self.eager_calls = 0
        key = self._cache_key()
        loaded = (progcache.load(key, kind=self._cache_kind,
                                 decode=_load_program)
                  if key is not None else None)
        if loaded is not None:
            # no symbol build, no shape inference, no trace: the program
            # and the bound zeros' shapes come from the entry
            self._program, meta = loaded
            dt = _as_torch_dtype(self._dtype)
            self._zeros = {n: torch.zeros(tuple(shape), dtype=dt,
                                          device=self._device)
                           for n, shape in meta["zeros"].items()}
            self.progcache_source = "disk"
            with _count_lock:
                _DISK_LOAD_COUNT += 1
        else:
            self._eval = self._symbol.build_eval()
            self._zeros = self._bind_zeros()
            with _count_lock:
                _COMPILE_COUNT += 1
            self.progcache_source = "compile"
            _witness.record_compile(
                self._cache_kind, key=key or "",
                shapes=repr(sorted(self._input_shapes.items())))
            if key is not None:
                # the fresh bind runs the program it stores, so a warm
                # restart computes what this process computed
                payload = self._export()
                self._program = _load_program(payload, {})[0]
                progcache.store(
                    key, payload, note=self._cache_kind,
                    kind=self._cache_kind,
                    meta={"zeros": {n: list(z.shape)
                                    for n, z in self._zeros.items()}})
        if self._device.type == "cuda" and _use_graph():
            self._capture()
            _witness.record_capture(self._cache_kind)

    def _fused_forward(self, vals) -> List[torch.Tensor]:
        """The bound forward on ``vals`` (name -> tensor or array, on the
        host or the device), without this predictor's own graph: the body
        the engine's trace-and-fuse stitches (and captures on a card)."""
        dt = _as_torch_dtype(self._dtype)
        with torch.no_grad():
            return self._run({n: _as_tensor(v).to(self._device, dt,
                                                  non_blocking=True)
                              for n, v in vals.items()})

    def _capture(self):
        """Two warm-up forwards on the predictor's stream, then one capture
        over static buffers (a capture launches nothing: the launch
        counters take it back out, and each replay adds it once)."""
        dev = self._device
        dt = _as_torch_dtype(self._dtype)
        self._static_in = {n: torch.zeros(self._input_shapes[n], dtype=dt,
                                          device=dev)
                           for n in self._input_names}
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad(), torch.cuda.stream(stream):
            for _ in range(CAPTURE_WARMUP):
                self._run(self._static_in)
                self.warmup_calls += 1
        graph = torch.cuda.CUDAGraph()

        def record():
            with torch.no_grad(), torch.cuda.graph(
                    graph, stream=stream, capture_error_mode="thread_local"):
                self._static_out = self._run(self._static_in)

        try:
            delta = _launches.capture(record)
        except Exception as e:
            self._static_in = self._static_out = None
            raise MXNetError("the predictor's forward at %s could not be "
                             "captured as a CUDA graph: %s"
                             % (self._input_shapes, e)) from e
        self._delta = delta
        self._graph, self._stream = graph, stream
        self.captures += 1

    # --- reference API surface -------------------------------------------
    def set_input(self, name: str, value):
        """MXPredSetInput."""
        if name not in self._inputs:
            raise MXNetError("unknown input %r (have %s)"
                             % (name, self._input_names))
        arr = value if isinstance(value, NDArray) else NDArray(
            _as_tensor(value))
        if tuple(arr.shape) != self._input_shapes[name]:
            raise MXNetError("input %r shape %s != bound shape %s"
                             % (name, arr.shape, self._input_shapes[name]))
        with self._run_lock:
            self._inputs[name] = arr

    def forward(self, **inputs) -> List[NDArray]:
        """MXPredForward; inputs may also be passed as kwargs. Each call
        returns its own outputs (on the predictor's device), safe for
        concurrent callers: the whole call holds the run lock."""
        with self._run_lock:
            for k, v in inputs.items():
                self.set_input(k, v)
            vals = {}
            for n in self._input_names:
                if self._inputs[n] is None:
                    raise MXNetError("input %r not set" % n)
                vals[n] = self._inputs[n]._data
            if self._graph is not None:
                outs = self._replay(vals)
            else:
                dt = _as_torch_dtype(self._dtype)
                with torch.no_grad():
                    outs = self._run({n: v.to(self._device, dt)
                                      for n, v in vals.items()})
                self.eager_calls += 1
            result = [NDArray(o) for o in outs]
            self._outputs = result
        return result

    def _replay(self, vals) -> List[torch.Tensor]:
        """Copy-in, replay and copy-out on the predictor's stream, ordered
        after the caller's stream (the inputs) and before it (the
        outputs). A pinned host input reaches the card in one
        non-blocking copy."""
        cur = torch.cuda.current_stream(self._device)
        stream = self._stream
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            for n, v in vals.items():
                self._static_in[n].copy_(v, non_blocking=True)
            self._graph.replay()
            outs = [o.clone() for o in self._static_out]
        cur.wait_stream(stream)
        for o in outs:
            o.record_stream(cur)
        _launches.replayed(self._delta)
        self.replays += 1
        return outs

    def get_output(self, index: int) -> NDArray:
        """MXPredGetOutput."""
        with self._run_lock:
            return self._outputs[index]

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    def capture_stats(self) -> Dict[str, object]:
        """The forward's path (``captured`` / ``eager``), its warm-up calls,
        captures, replays and eager calls."""
        return {"path": "captured" if self._graph is not None else "eager",
                "warmup_calls": self.warmup_calls, "captures": self.captures,
                "replays": self.replays, "eager_calls": self.eager_calls}

    def _shared(self) -> Dict[str, object]:
        """What a reshape shares with this predictor."""
        out = {"_symbol": self._symbol, "_arg_params": self._arg_params,
               "_aux_params": self._aux_params, "_dtype": self._dtype,
               "_zero_bound": self._zero_bound}
        fp = getattr(self, "_progcache_model_fp", None)
        if fp is not None:
            out["_progcache_model_fp"] = fp
        return out

    def reshape(self, new_input_shapes: Dict[str, tuple],
                device=None) -> "Predictor":
        """MXPredReshape: bind again at new shapes, sharing the weights
        (the same tensors, no copy). ``device`` other than this
        predictor's copies the weights there."""
        p = self.__class__.__new__(self.__class__)
        for k, v in self._shared().items():
            setattr(p, k, v)
        p._device = (self._device if device is None
                     else resolve_device(device))
        if p._device != self._device:
            p._arg_params = {n: NDArray(a._data.to(p._device))
                             for n, a in self._arg_params.items()}
            p._aux_params = {n: NDArray(a._data.to(p._device))
                             for n, a in self._aux_params.items()}
        p._input_names = list(new_input_shapes)
        p._input_shapes = {k: tuple(v) for k, v in new_input_shapes.items()}
        p._init_run_state()
        p._compile()
        return p

    def quantize(self, weight_dtype: str = "int8", act_dtype: str = "int8"):
        """Post-training quantization: a :class:`~mxnet_tpu_torch.quant.
        QuantizedPredictor` over the same symbol and weights at the same
        shapes and device, each FullyConnected / Convolution weight stored
        per-channel ``weight_dtype`` (int8 / fp8_e4m3). This predictor is
        left as it is."""
        from . import quant as _quant

        return _quant.quantize_predictor(
            self, _quant.QuantConfig(weight_dtype=weight_dtype,
                                     act_dtype=act_dtype))

    def export(self, path: str):
        """The reference writes a StableHLO artifact here; not ported."""
        raise MXNetError("Predictor.export is not ported (the reference "
                         "serializes a StableHLO program); rebind from the "
                         "symbol JSON and params instead")


def create(prefix: str, epoch: int, input_shapes: Dict[str, tuple],
           dtype="float32", device=None) -> Predictor:
    """A Predictor straight from a training checkpoint pair
    (``prefix-symbol.json`` + ``prefix-%04d.params``)."""
    return Predictor("%s-symbol.json" % prefix,
                     "%s-%04d.params" % (prefix, epoch), input_shapes, dtype,
                     device=device)
