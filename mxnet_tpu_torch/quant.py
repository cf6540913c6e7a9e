"""Post-training weight quantization for the decode path.

Counterpart of ``mxnet_tpu/quant.py``'s dtype tables, ``QuantConfig`` and
its pass over a ``DecodeModel``:

- **Weights**: per-channel symmetric int8 or fp8-e4m3
  (:func:`quantize_params`, the math of ``ops.contrib.quantize_symmetric``).
  Each quantized ``<name>`` is joined by a ``<name>_scale`` entry in the
  params dict.
- **Products**: ``ops.matrix.quantized_matmul``: dynamic per-row int8
  activations into an int8 x int8 product (``act_dtype="int8"``, the
  default) or dequant on load into a bf16 / f32 product (``"bf16"`` /
  ``"float32"``, and every fp8 weight).
- **Models**: :func:`quantize_decode_model` rewrites a ``DecodeModel``'s
  projection, FFN and head weights; the new model's products route
  through ``quantized_matmul`` (``serving/generate/model.py`` ``_mm``).

Nothing here runs unless a config asks for it, and a model without
``_scale`` entries computes exactly as before. The bytes held in
quantized weights are the registry's ``quant_params_bytes{dtype}`` gauge
(and :func:`quant_params_bytes`).
- **Fixed-shape predictors**: :class:`QuantizedPredictor` stores each
  FullyConnected / Convolution weight (:func:`quantizable_weights`)
  per-channel int8 / fp8 and widens it inside the forward (inside the
  captured graph on a card), as the reference dequantizes on load;
  ``reshape`` shares one quantization across a bucket ladder.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, List, Optional

import torch

from . import predict as predict_mod
from . import telemetry as _telemetry
from .base import MXNetError
from .ops.contrib import dequantize_symmetric, quantize_symmetric

#: canonical weight formats -> element bytes
WEIGHT_DTYPES = {"int8": 1, "fp8_e4m3": 1}
#: canonical KV-cache dtypes -> element bytes
KV_DTYPES = {"float32": 4, "bfloat16": 2, "int8": 1}

_WEIGHT_ALIASES = {"int8": "int8", "fp8": "fp8_e4m3", "fp8_e4m3": "fp8_e4m3",
                   "float8_e4m3": "fp8_e4m3"}
_ACT_ALIASES = {"int8": "int8", "bf16": "bf16", "bfloat16": "bf16",
                "f32": "float32", "fp32": "float32", "float32": "float32"}
_KV_ALIASES = {"f32": "float32", "fp32": "float32", "float32": "float32",
               "bf16": "bfloat16", "bfloat16": "bfloat16", "int8": "int8"}


def normalize_weight_dtype(name: str) -> str:
    """Canonicalize an ``MXNET_QUANT_WEIGHT_DTYPE`` spelling."""
    try:
        return _WEIGHT_ALIASES[str(name).strip().lower()]
    except KeyError:
        raise MXNetError(
            "MXNET_QUANT_WEIGHT_DTYPE must be one of %s, got %r"
            % (sorted(set(_WEIGHT_ALIASES)), name)) from None


def normalize_kv_dtype(name: str) -> str:
    """Canonicalize an ``MXNET_DECODE_KV_DTYPE`` spelling (f32|bf16|int8,
    long forms accepted)."""
    try:
        return _KV_ALIASES[str(name).strip().lower()]
    except KeyError:
        raise MXNetError(
            "MXNET_DECODE_KV_DTYPE must be one of %s, got %r"
            % (sorted(set(_KV_ALIASES)), name)) from None


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Weight-quantization knobs, ``MXNET_QUANT_WEIGHT_DTYPE`` /
    ``MXNET_QUANT_ACT_DTYPE`` read at construction.

    ``weight_dtype``: int8 | fp8_e4m3. ``act_dtype`` picks int8 weights'
    product: "int8" (dynamic activation quantization + the int8 product)
    or "bf16" / "float32" (dequant on load); fp8 weights always dequant on
    load."""
    weight_dtype: str = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "MXNET_QUANT_WEIGHT_DTYPE", "int8"))
    act_dtype: str = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "MXNET_QUANT_ACT_DTYPE", "int8"))

    def __post_init__(self):
        object.__setattr__(self, "weight_dtype",
                           normalize_weight_dtype(self.weight_dtype))
        act = str(self.act_dtype).strip().lower()
        if act not in _ACT_ALIASES:
            raise MXNetError(
                "MXNET_QUANT_ACT_DTYPE must be one of %s, got %r"
                % (sorted(set(_ACT_ALIASES)), self.act_dtype))
        object.__setattr__(self, "act_dtype", _ACT_ALIASES[act])


_bytes_lock = threading.Lock()
_params_bytes: Dict[str, int] = {}


def _account_params_bytes(dtype: str, nbytes: int):
    with _bytes_lock:
        _params_bytes[dtype] = _params_bytes.get(dtype, 0) + int(nbytes)
        total = _params_bytes[dtype]
    _telemetry.registry.gauge(
        "quant_params_bytes", labels={"dtype": dtype},
        help="bytes held in quantized weight arrays, by target dtype"
    ).set(total)


def quant_params_bytes() -> Dict[str, int]:
    """Bytes held in quantized weights made so far, by target dtype."""
    with _bytes_lock:
        return dict(_params_bytes)


def quantize_weight(w, weight_dtype: str = "int8", axis=0):
    """Per-channel symmetric quantization of one weight tensor: ``(q,
    scale)``, ``scale`` squeezed to the kept channel axes ((O, I) ->
    (O,); stacked (L, O, I) with axis (0, 1) -> (L, O))."""
    weight_dtype = normalize_weight_dtype(weight_dtype)
    q, scale = quantize_symmetric(torch.as_tensor(w), weight_dtype,
                                  axis=axis)
    keep = sorted({a % q.ndim for a in
                   (axis if isinstance(axis, (tuple, list)) else (axis,))})
    return q, scale.reshape(tuple(q.shape[a] for a in keep))


def dequantize_weight(q, scale):
    """Widen a quantized weight back to f32, the inverse of
    :func:`quantize_weight` (the channel axes leading, as in the (L?, O,
    I) layouts here)."""
    s = torch.as_tensor(scale)
    s = s.reshape(tuple(s.shape) + (1,) * (q.ndim - s.ndim))
    return dequantize_symmetric(q, s)


#: DecodeModel weights the pass rewrites, with their channel axes
#: ((L, O, I) stacked -> (0, 1); flat (O, I) -> 0). embed stays f32 (a
#: gather table, not a product's operand); norms and biases are small.
DECODE_QUANT_WEIGHTS = {
    "wq": (0, 1), "wk": (0, 1), "wv": (0, 1), "wo": (0, 1),
    "w1": (0, 1), "w2": (0, 1), "pred_w": 0,
}


def quantize_params(params: Dict[str, torch.Tensor], names_axes: Dict,
                    weight_dtype: str = "int8") -> Dict[str, torch.Tensor]:
    """A new params dict where each ``names_axes`` entry is quantized and
    joined by its ``<name>_scale``; the other entries are shared."""
    weight_dtype = normalize_weight_dtype(weight_dtype)
    out = dict(params)
    qbytes = 0
    for name, axis in names_axes.items():
        if name not in params:
            raise MXNetError("quantize_params: no param %r" % name)
        q, scale = quantize_weight(params[name], weight_dtype, axis)
        out[name] = q
        out[name + "_scale"] = scale
        qbytes += q.numel() * WEIGHT_DTYPES[weight_dtype]
    _account_params_bytes(weight_dtype, qbytes)
    return out


def quantize_decode_model(model, config: Optional[QuantConfig] = None):
    """The PTQ pass over a ``DecodeModel``: a new model on the same device
    whose projection, FFN and head weights are int8 / fp8 with
    per-channel scales, its products taking ``config.act_dtype``'s
    strategy. The f32 model is left as it is."""
    from .serving.generate.model import DecodeModel

    config = config or QuantConfig()
    params = quantize_params(model.params, DECODE_QUANT_WEIGHTS,
                             config.weight_dtype)
    qm = DecodeModel(params, model.spec)
    qm.quant_act = config.act_dtype
    return qm


# --- quantized fixed-shape predictor ---------------------------------------
def quantizable_weights(symbol) -> List[str]:
    """Names of the weights feeding FullyConnected / Convolution weight
    slots, the products' operands worth quantizing (channel axis 0, the
    (O, I...) orientation of both ops)."""
    names = []
    for node in symbol._nodes():
        if node.is_var or node.op.name not in ("FullyConnected",
                                               "Convolution"):
            continue
        if len(node.inputs) > 1:
            child, _idx = node.inputs[1]
            if child.is_var and child.name not in names:
                names.append(child.name)
    return names


class QuantizedPredictor(predict_mod.Predictor):
    """A Predictor whose quantizable weights are held as per-channel
    ``(q, scale)`` pairs and widened to f32 inside the forward (so inside
    the captured graph on a card): weight bytes shrink 4x, accuracy tracks
    per-channel PTQ. The f32 weights stay shared with the predictor it was
    made from; a ``reshape`` shares the quantization too."""

    def __init__(self, symbol_json: str, params,
                 input_shapes: Dict[str, tuple], dtype="float32",
                 device=None, qconfig: Optional[QuantConfig] = None):
        self._qconfig = qconfig or QuantConfig()
        super().__init__(symbol_json, params, input_shapes, dtype, device)

    def _quantize_params(self):
        """name -> f32 tensor | {"q", "scale"} for every argument weight,
        made once and shared across reshapes (the bucket ladder)."""
        qnames = set(quantizable_weights(self._symbol))
        qvals: Dict[str, object] = {}
        qbytes = 0
        for n, a in self._arg_params.items():
            w = a._data
            if n in qnames and w.ndim >= 2:
                q, scale = quantize_weight(w, self._qconfig.weight_dtype,
                                           axis=0)
                qvals[n] = {"q": q, "scale": scale}
                qbytes += q.numel() * WEIGHT_DTYPES[self._qconfig.weight_dtype]
            else:
                qvals[n] = w
        _account_params_bytes(self._qconfig.weight_dtype, qbytes)
        return qvals

    def _compile(self):
        if not hasattr(self, "_qvals"):
            self._qvals = self._quantize_params()
        super()._compile()

    def _raw_params(self) -> Dict[str, object]:
        return self._qvals

    def _widen(self, raw) -> Dict[str, torch.Tensor]:
        # dequant on load, inside the forward (and the exported program)
        return {n: dequantize_weight(v["q"], v["scale"])
                if isinstance(v, dict) else v
                for n, v in raw.items()}

    _cache_kind = "quant"

    def _cache_extra(self) -> str:
        return "quant_predictor:%s:%s" % (self._qconfig.weight_dtype,
                                          self._qconfig.act_dtype)

    def _shared(self) -> Dict[str, object]:
        return dict(super()._shared(), _qconfig=self._qconfig,
                    _qvals=self._qvals)

    def reshape(self, new_input_shapes: Dict[str, tuple],
                device=None) -> "QuantizedPredictor":
        """MXPredReshape sharing the weights and their quantization: a
        bucket ladder quantizes once. ``device`` must be this
        predictor's."""
        if device is not None and predict_mod.resolve_device(device) \
                != self._device:
            raise MXNetError("QuantizedPredictor.reshape shares its "
                             "quantized weights: it binds on its own device")
        return super().reshape(new_input_shapes)

    def export(self, path: str):
        raise MXNetError(
            "QuantizedPredictor.export is not supported — export the f32 "
            "Predictor and quantize at load time instead")


def quantize_predictor(predictor: "predict_mod.Predictor",
                       config: Optional[QuantConfig] = None
                       ) -> QuantizedPredictor:
    """PTQ over an existing Predictor: the same symbol and weights bound
    as a :class:`QuantizedPredictor` at the same shapes and device."""
    params = {n: a for n, a in predictor._arg_params.items()}
    params.update({"aux:%s" % n: a
                   for n, a in predictor._aux_params.items()})
    return QuantizedPredictor(
        predictor._symbol.tojson(), params, predictor._input_shapes,
        dtype=predictor._dtype, device=predictor._device, qconfig=config)
