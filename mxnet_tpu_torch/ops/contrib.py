"""Contrib operators.

Counterpart of ``mxnet_tpu/ops/contrib.py`` (reference
src/operator/contrib/): CTC loss, fft / ifft, count_sketch, quantize /
dequantize, the SSD ops (MultiBoxPrior / Target / Detection), the RCNN
``Proposal`` and ``Correlation``.

Quantization: the symmetric per-tensor / per-channel math shared by the
``quantize`` / ``dequantize`` ops and the weight quantization pass
(``mxnet_tpu_torch.quant``). int8 is ``torch.int8``, fp8-e4m3
``torch.float8_e4m3fn``; rounding is half to even (``torch.round``, as
``jnp.round``). The fp8 path does not clip: ``|data / scale| <= 448`` by
construction, and a cast of a value a rounding step above 448 lands on 448
in both packages.

The detection ops run over static shapes without a host sync (no
``.item()``, no ``nonzero``, no boolean-mask indexing, no Python branch on
a tensor), so a graph holding them can be captured. Where the JAX package
departs from MXNet the port follows the JAX package:

- ``MultiBoxTarget``'s forced matches are scatters with duplicate indices,
  where XLA lets the last writer win: the largest ground-truth row that
  claims an anchor wins it, picked here by ``scatter_reduce(amax)`` (a
  duplicate ``index_put_`` has no defined winner on the card). Padding
  rows, whose IoU is -1 everywhere, all claim anchor 0, so a valid box
  whose best anchor is 0 loses its forced match to them.
- ``negative_mining_ratio`` and the other mining parameters are ignored:
  every anchor that is not positive gets class 0 (none is ignored).
- NMS (``MultiBoxDetection``, ``Proposal``) is class-agnostic and runs a
  static number of greedy rounds, the first maximum picked each round;
  ``force_suppress`` is ignored.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .elemwise import abs_
from .registry import defop

_NEG = -1e9

#: symmetric target formats -> the largest exactly representable magnitude
#: the scale maps absmax onto (int8: 127; fp8-e4m3: 448)
SYMMETRIC_QMAX = {"int8": 127.0, "fp8_e4m3": 448.0}


def _symmetric_dtype(out_type: str) -> torch.dtype:
    if out_type == "int8":
        return torch.int8
    if out_type == "fp8_e4m3":
        return torch.float8_e4m3fn
    raise ValueError("symmetric quantization supports int8/fp8_e4m3, got %r"
                     % (out_type,))


def true_divide(num, den):
    """``num / den`` as a division of two tensors, either of which may be
    given as a Python number. PyTorch divides a CUDA tensor by a Python
    number as a product with the number's reciprocal (one ulp off for
    about one value in twenty), and a Python number by any tensor as the
    tensor's reciprocal times the number, on every device; the reference
    divides. A number is made a tensor like the other operand first, so
    the card and the CPU both divide."""
    if not isinstance(num, torch.Tensor):
        num = torch.full_like(den, num)
    elif not isinstance(den, torch.Tensor):
        den = torch.full_like(num, den)
    return num / den


def symmetric_scale(amax, qmax: float):
    """``max(amax, 1e-12) / qmax`` in f32, a true division on every device
    (:func:`true_divide`), equal to the reference's ``amax / qmax``."""
    return true_divide(torch.clamp(amax, min=1e-12).to(torch.float32), qmax)


def quantize_symmetric(data, out_type: str = "int8", axis=None):
    """``q = round(data / scale)`` with ``scale = absmax / qmax``.

    ``axis=None`` is per-tensor (one scale); an int or tuple names the
    channel axes kept distinct, the scale reducing over every other axis.
    Returns ``(q, scale)`` with ``scale`` f32 and keepdims-shaped, so
    ``q * scale`` broadcasts back."""
    qmax = SYMMETRIC_QMAX[out_type]
    dtype = _symmetric_dtype(out_type)
    if axis is None:
        amax = data.abs().amax().reshape((1,) * data.ndim)
    else:
        keep = {a % data.ndim for a in
                (axis if isinstance(axis, (tuple, list)) else (axis,))}
        reduce_axes = tuple(a for a in range(data.ndim) if a not in keep)
        amax = data.abs().amax(dim=reduce_axes, keepdim=True) \
            if reduce_axes else data.abs()
    scale = symmetric_scale(amax, qmax)
    q = data / scale
    if out_type == "int8":
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return q.to(dtype), scale


def dequantize_symmetric(q, scale):
    """Inverse of :func:`quantize_symmetric` (f32 result)."""
    return q.to(torch.float32) * scale.to(torch.float32)


@defop("quantize", arg_names=("data", "min_range", "max_range"),
       param_spec={"out_type": "uint8", "axis": None}, num_outputs=3,
       no_grad_inputs=("min_range", "max_range"))
def _quantize(attrs, data, min_range, max_range):
    """Affine float -> uint8 from the calibration range; with ``out_type``
    int8 / fp8_e4m3, symmetric per-tensor or per-``axis`` (the ranges are
    then ignored, and the range outputs carry -/+ scale * qmax)."""
    out_type = attrs["out_type"]
    if out_type in SYMMETRIC_QMAX:
        q, scale = quantize_symmetric(data, out_type, attrs["axis"])
        qmax = SYMMETRIC_QMAX[out_type]
        return q, -scale * qmax, scale * qmax
    qmax = 255.0
    scale = true_divide(qmax, max_range - min_range)
    q = torch.clamp(torch.round((data - min_range) * scale), 0, qmax)
    return q.to(torch.uint8), min_range, max_range


@defop("dequantize", arg_names=("data", "min_range", "max_range"),
       param_spec={"out_type": "float32"},
       no_grad_inputs=("data", "min_range", "max_range"))
def _dequantize(attrs, data, min_range, max_range):
    """uint8 back to f32 through the range; int8 / fp8 symmetric, where
    ``max_range`` carries scale * qmax."""
    if data.dtype in (torch.int8, torch.float8_e4m3fn):
        qmax = SYMMETRIC_QMAX["int8" if data.dtype == torch.int8
                              else "fp8_e4m3"]
        return dequantize_symmetric(data, true_divide(max_range, qmax))
    scale = true_divide(max_range - min_range, 255.0)
    return data.to(torch.float32) * scale + min_range


def _constant(values, device):
    """A small f32 host array as a tensor on ``device`` made by fill
    kernels, one an element: no host-to-device copy, which a CUDA graph
    being captured cannot hold."""
    flat = [torch.full((), float(v), dtype=torch.float32, device=device)
            for v in np.asarray(values, np.float32).reshape(-1)]
    return torch.stack(flat).reshape(np.shape(values))


# --- CTC loss (reference contrib/ctc_loss.cc) ---------------------------------
@defop("ctc_loss", arg_names=("data", "label"), param_spec={},
       no_grad_inputs=("label",), py_name="ctc_loss")
def _ctc_loss(attrs, data, label):
    """Connectionist temporal classification loss of ``data`` (T, B,
    alphabet) activations against ``label`` (B, L), blank 0 and labels
    0-padded: each example's negative log likelihood (B,), from the
    log-space forward recursion over T (alpha carried step to step). The
    gradient comes through autograd, as the JAX package's through
    autodiff."""
    t_len, batch, _ = data.shape
    dev = data.device
    logp = torch.log_softmax(data, dim=-1)
    lab = label.to(torch.int64)
    llen = (lab > 0).sum(dim=1)
    s = 2 * lab.shape[1] + 1
    # the extended sequence: blank, l1, blank, l2, ..., blank
    ext = torch.zeros((batch, s), dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab
    pos = torch.arange(s, device=dev)[None, :]
    valid = pos < (2 * llen + 1)[:, None]
    ext_m2 = F.pad(ext, (2, 0))[:, :s]
    can_skip = (ext != 0) & (ext != ext_m2) & (pos >= 2)
    neg = torch.full((), _NEG, dtype=logp.dtype, device=dev)
    first = torch.where(llen > 0, torch.gather(logp[0], 1, ext[:, 1:2])[:, 0],
                        neg)
    alpha = torch.where(pos == 0, logp[0, :, 0:1],
                        torch.where(pos == 1, first[:, None], neg))
    for t in range(1, t_len):
        emit = torch.gather(logp[t], 1, ext)
        a_m1 = F.pad(alpha, (1, 0), value=_NEG)[:, :s]
        a_m2 = F.pad(alpha, (2, 0), value=_NEG)[:, :s]
        stay = torch.logaddexp(alpha, a_m1)
        full = torch.where(can_skip, torch.logaddexp(stay, a_m2), stay)
        alpha = torch.where(valid, full + emit, neg)
    last = torch.gather(alpha, 1, (2 * llen)[:, None])[:, 0]
    last2 = torch.gather(alpha, 1, (2 * llen - 1).clamp(min=0)[:, None])[:, 0]
    return -torch.logaddexp(last, torch.where(llen > 0, last2, neg))


# --- FFT (reference contrib/fft.cc: interleaved re / im) ---------------------
# ``torch.fft`` is the port of ``jnp.fft``: neither is a Pallas kernel
@defop("fft", arg_names=("data",), param_spec={"compute_size": 128})
def _fft(attrs, data):
    """FFT along the last axis; the output interleaves the real and
    imaginary parts, (..., 2d), in the input's type (complex math in f32:
    ``torch.fft`` has no bf16)."""
    f = torch.fft.fft(data.to(torch.float32).to(torch.complex64), dim=-1)
    return torch.stack([f.real, f.imag], dim=-1).reshape(
        data.shape[:-1] + (2 * data.shape[-1],)).to(data.dtype)


@defop("ifft", arg_names=("data",), param_spec={"compute_size": 128})
def _ifft(attrs, data):
    """The inverse FFT of interleaved (..., 2d) input, real part, scaled by
    d (cuFFT's unnormalised inverse), in the input's type."""
    d = data.shape[-1] // 2
    x = data.reshape(data.shape[:-1] + (d, 2)).to(torch.float32)
    c = torch.complex(x[..., 0], x[..., 1])
    return (torch.fft.ifft(c, dim=-1).real * d).to(data.dtype)


# --- count_sketch (reference contrib/count_sketch.cc) ------------------------
@defop("count_sketch", arg_names=("data", "h", "s"),
       param_spec={"out_dim": 0, "processing_batch_size": 32},
       no_grad_inputs=("h", "s"))
def _count_sketch(attrs, data, h, s):
    """out[:, h[i]] += s[i] * data[:, i], repeated buckets summed (an
    ``index_add``: on the card its sums land in atomic order)."""
    hh = h.reshape(-1).to(torch.int64)
    contrib = data * s.reshape(-1).to(data.dtype)[None, :]
    out = torch.zeros((data.shape[0], int(attrs["out_dim"])),
                      dtype=data.dtype, device=data.device)
    return out.index_add(1, hh, contrib)


# --- SSD (reference contrib/multibox_prior.cc, multibox_target.cc,
# multibox_detection.cc) -------------------------------------------------------
@defop("MultiBoxPrior", arg_names=("data",),
       param_spec={"sizes": (1.0,), "ratios": (1.0,), "clip": False,
                   "steps": (-1.0, -1.0), "offsets": (0.5, 0.5)},
       no_grad_inputs=("data",))
def _multibox_prior(attrs, data):
    """Anchors of the (B, C, H, W) feature map: (1, H * W * A, 4) corner
    boxes in [0, 1], f32, A = sizes + ratios - 1 at each position (every
    size at ratios[0], then ratios[1:] at sizes[0])."""
    h, w = data.shape[2], data.shape[3]
    sizes = [float(x) for x in attrs["sizes"]]
    ratios = [float(x) for x in attrs["ratios"]]
    steps, offs = attrs["steps"], attrs["offsets"]
    step_y = float(steps[0]) if float(steps[0]) > 0 else 1.0 / h
    step_x = float(steps[1]) if float(steps[1]) > 0 else 1.0 / w
    dev = data.device
    cy = (torch.arange(h, dtype=torch.float32, device=dev)
          + float(offs[0])) * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev)
          + float(offs[1])) * step_x
    wh = [(sz * np.sqrt(ratios[0]) / 2, sz / np.sqrt(ratios[0]) / 2)
          for sz in sizes]
    wh += [(sizes[0] * np.sqrt(r) / 2, sizes[0] / np.sqrt(r) / 2)
           for r in ratios[1:]]
    half = _constant(np.asarray(wh, np.float32), dev)[None, None]
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    centers = torch.stack([cxg, cyg], dim=-1)[:, :, None, :]
    boxes = torch.cat([centers - half, centers + half], dim=-1).reshape(
        1, -1, 4)
    return boxes.clamp(0.0, 1.0) if attrs["clip"] else boxes


def iou_matrix(a, b):
    """IoU of corner boxes a (..., N, 4) against b (..., M, 4): (..., N,
    M), the JAX package's arithmetic (intersection over the union, the
    union at least 1e-12)."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (br - tl).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    ea = (a[..., 2:] - a[..., :2]).clamp(min=0)
    eb = (b[..., 2:] - b[..., :2]).clamp(min=0)
    area_a = ea[..., 0] * ea[..., 1]
    area_b = eb[..., 0] * eb[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :]
                    - inter).clamp(min=1e-12)


def _f32_values(values):
    """Python floats holding the f32 roundings of ``values``: the JAX
    package keeps its variances in an f32 array, which f64 arithmetic then
    reads as these."""
    return [float(v) for v in np.asarray(values, np.float32)]


def _center_form(boxes):
    """(width, height, centre x, centre y) of corner boxes (..., 4)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return w, h, (boxes[..., 0] + boxes[..., 2]) / 2, \
        (boxes[..., 1] + boxes[..., 3]) / 2


@defop("MultiBoxTarget", arg_names=("anchor", "label", "cls_pred"),
       param_spec={"overlap_threshold": 0.5, "ignore_label": -1.0,
                   "negative_mining_ratio": -1.0,
                   "negative_mining_thresh": 0.5,
                   "minimum_negative_samples": 0,
                   "variances": (0.1, 0.1, 0.2, 0.2)},
       num_outputs=3, no_grad_inputs=("anchor", "label", "cls_pred"))
def _multibox_target(attrs, anchor, label, cls_pred):
    """Anchor-to-ground-truth matching: (loc_target (B, A * 4), loc_mask
    (B, A * 4), cls_target (B, A)). ``label`` (B, G, 5) rows are [class,
    xmin, ymin, xmax, ymax], class -1 for padding. An anchor is positive
    if its best IoU reaches ``overlap_threshold`` or a ground truth claims
    it as its best anchor (the forced match, the last claimant winning:
    module docstring); its class target is the box's class + 1, every
    other anchor's 0. The arithmetic is in the anchors' and the label's
    promoted type (f32 under bf16 compute: the executor keeps the label
    f32, where the JAX package casts its boxes to bf16)."""
    # each quantity in the type the JAX package computes it in: the
    # anchors' own (f32), promoted where the label's boxes enter
    dt = torch.promote_types(anchor.dtype, label.dtype)
    anchors = anchor.reshape(-1, 4)
    na = anchors.shape[0]
    lab = label
    batch, ng = lab.shape[0], lab.shape[1]
    var = _f32_values(attrs["variances"])
    gt_valid = lab[..., 0] >= 0                               # (B, G)
    gt_boxes = lab[..., 1:5]
    iou = iou_matrix(anchors.expand(batch, na, 4), gt_boxes)  # (B, A, G)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou = iou.amax(dim=2)
    best_gt = torch.argmax(iou, dim=2)          # the first maximum
    matched = best_iou >= float(attrs["overlap_threshold"])
    best_anchor = torch.argmax(iou, dim=1)                    # (B, G)
    rows = torch.arange(ng, device=lab.device).expand(batch, ng)
    winner = torch.full((batch, na), -1, dtype=torch.int64,
                        device=lab.device).scatter_reduce(
        1, best_anchor, rows, reduce="amax")
    won = winner.clamp(min=0)
    forced = (winner >= 0) & torch.gather(gt_valid, 1, won)
    gt_idx = torch.where(forced, won, best_gt)
    pos = matched | forced
    g = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(batch, na, 4))
    aw, ah, acx, acy = _center_form(anchors)
    gw = (g[..., 2] - g[..., 0]).clamp(min=1e-12)
    gh = (g[..., 3] - g[..., 1]).clamp(min=1e-12)
    gcx = (g[..., 0] + g[..., 2]) / 2
    gcy = (g[..., 1] + g[..., 3]) / 2
    t = torch.stack([(gcx - acx) / aw / var[0], (gcy - acy) / ah / var[1],
                     torch.log(gw / aw) / var[2],
                     torch.log(gh / ah) / var[3]], dim=-1)
    posf = pos[..., None].expand(batch, na, 4)
    loc_target = torch.where(posf, t, torch.zeros_like(t)).reshape(batch, -1)
    loc_mask = posf.to(dt).reshape(batch, -1)
    cls = torch.gather(lab[..., 0], 1, gt_idx) + 1.0
    cls_target = torch.where(pos, cls, torch.zeros_like(cls))
    return loc_target, loc_mask, cls_target


def nms_keep(boxes, scores, valid, iou_thresh, topk):
    """Greedy NMS over (B, N) boxes at once, ``topk`` rounds (all N for
    ``topk`` <= 0): each round keeps the highest live score (the first
    among equal ones), then retires it and every live box whose IoU with
    it exceeds ``iou_thresh``. A round with nothing live keeps nothing.
    Returns the (B, N) keep mask. No host sync: a fixed number of
    rounds, every choice a gather or a scatter."""
    batch, n = scores.shape
    rounds = n if topk <= 0 else min(int(topk), n)
    neg = torch.full((), _NEG, dtype=scores.dtype, device=scores.device)
    live = torch.where(valid, scores, neg)
    keep = torch.zeros((batch, n), dtype=torch.bool, device=scores.device)
    for _ in range(rounds):
        i = torch.argmax(live, dim=1, keepdim=True)          # (B, 1)
        best = torch.gather(live, 1, i)
        box = torch.gather(boxes, 1, i[..., None].expand(batch, 1, 4))
        iou = iou_matrix(box, boxes)[:, 0, :]                 # (B, N)
        live = torch.where((iou > iou_thresh) & (live > neg), neg, live)
        live = live.scatter(1, i, neg.expand(batch, 1))
        keep = keep.scatter(1, i, torch.gather(keep, 1, i) | (best > neg))
    return keep


@defop("MultiBoxDetection", arg_names=("cls_prob", "loc_pred", "anchor"),
       param_spec={"clip": True, "threshold": 0.01, "background_id": 0,
                   "nms_threshold": 0.5, "force_suppress": False,
                   "variances": (0.1, 0.1, 0.2, 0.2), "nms_topk": -1},
       no_grad_inputs=("cls_prob", "loc_pred", "anchor"))
def _multibox_detection(attrs, cls_prob, loc_pred, anchor):
    """Decode and NMS: (B, A, 6) rows [class, score, xmin, ymin, xmax,
    ymax] for every anchor, class -1 where the box is not kept. Each
    anchor's class is its best non-background one (re-based past the
    background row), its score that class's probability."""
    # the decode in the type of the JAX package's f32 variances and
    # anchors promoted with the location's; the scores in the class
    # probabilities' own type
    dt = torch.promote_types(loc_pred.dtype, torch.float32)
    anchors = anchor.reshape(-1, 4)
    var = _f32_values(attrs["variances"])
    bg = int(attrs["background_id"])
    cp = cls_prob
    batch = cp.shape[0]
    aw, ah, acx, acy = _center_form(anchors)
    loc = loc_pred.to(dt).reshape(batch, -1, 4)
    cx = loc[..., 0] * var[0] * aw + acx
    cy = loc[..., 1] * var[1] * ah + acy
    hw = torch.exp(loc[..., 2] * var[2]) * aw / 2
    hh = torch.exp(loc[..., 3] * var[3]) * ah / 2
    boxes = torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)
    if attrs["clip"]:
        boxes = boxes.clamp(0.0, 1.0)
    rows = torch.arange(cp.shape[1], device=cp.device)[None, :, None]
    scores = torch.where(rows == bg, torch.full_like(cp, -1.0), cp)
    score = scores.amax(dim=1)
    cls_id = torch.argmax(scores, dim=1)        # the first maximum
    keep = nms_keep(boxes, score, score > float(attrs["threshold"]),
                    float(attrs["nms_threshold"]), int(attrs["nms_topk"]))
    out_cls = torch.where(keep, (cls_id - int(bg == 0)).to(dt),
                          torch.full_like(boxes[..., 0], -1.0))
    return torch.cat([out_cls[..., None], score[..., None].to(dt), boxes],
                     dim=-1)


# --- Faster-RCNN proposal (reference contrib/proposal.cc) ---------------------
def _base_anchors(stride, scales, ratios):
    """The RPN's anchors of one position, centred at (stride - 1) / 2:
    (ratios x scales, 4), ratio-major, as the JAX package rounds them."""
    base = []
    ctr = (stride - 1) / 2.0
    size = stride * stride
    for r in ratios:
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            base.append([ctr - (ws * s - 1) / 2, ctr - (hs * s - 1) / 2,
                         ctr + (ws * s - 1) / 2, ctr + (hs * s - 1) / 2])
    return np.asarray(base, np.float32)


@defop("Proposal", arg_names=("cls_prob", "bbox_pred", "im_info"),
       param_spec={"rpn_pre_nms_top_n": 6000, "rpn_post_nms_top_n": 300,
                   "threshold": 0.7, "rpn_min_size": 16,
                   "scales": (4.0, 8.0, 16.0, 32.0),
                   "ratios": (0.5, 1.0, 2.0), "feature_stride": 16,
                   "output_score": False, "iou_loss": False},
       num_outputs=lambda attrs: 2 if attrs["output_score"] else 1,
       no_grad_inputs=("cls_prob", "bbox_pred", "im_info"))
def _proposal(attrs, cls_prob, bbox_pred, im_info):
    """RPN proposals of one image: anchors shifted over the (H, W) map,
    decoded by ``bbox_pred``, clipped to ``im_info`` (height, width,
    scale), those under ``rpn_min_size`` x scale left out, NMS over
    ``rpn_post_nms_top_n`` rounds, then the post-NMS top n by score (the
    lower index first among ties, never ``torch.topk``): rois (n, 5)
    [0, x1, y1, x2, y2], and with ``output_score`` the scores (n, 1).
    ``rpn_pre_nms_top_n`` and ``iou_loss`` are ignored, as in the JAX
    package."""
    from .matrix import stable_topk   # matrix imports this module

    stride = int(attrs["feature_stride"])
    post_n = int(attrs["rpn_post_nms_top_n"])
    _, a2, h, w = cls_prob.shape
    na = a2 // 2
    dev = cls_prob.device
    base = _constant(_base_anchors(
        stride, [float(s) for s in attrs["scales"]],
        [float(r) for r in attrs["ratios"]]), dev)
    shift_x = torch.arange(w, dtype=torch.float32, device=dev) * stride
    shift_y = torch.arange(h, dtype=torch.float32, device=dev) * stride
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], dim=-1).reshape(-1, 1, 4)
    anchors = (base[None] + shifts).reshape(-1, 4)
    scores = cls_prob[0, na:].to(torch.float32).permute(1, 2, 0).reshape(-1)
    deltas = bbox_pred[0].to(torch.float32).reshape(na, 4, h, w).permute(
        2, 3, 0, 1).reshape(-1, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    acx = anchors[:, 0] + aw / 2
    acy = anchors[:, 1] + ah / 2
    cx = deltas[:, 0] * aw + acx
    cy = deltas[:, 1] * ah + acy
    pw = torch.exp(deltas[:, 2]) * aw
    ph = torch.exp(deltas[:, 3]) * ah
    info = im_info.to(torch.float32)
    zero = torch.zeros((), device=dev)
    im_h, im_w = info[0, 0], info[0, 1]

    def clip(x, hi):
        return torch.minimum(torch.maximum(x, zero), hi - 1)

    boxes = torch.stack([clip(cx - pw / 2, im_w), clip(cy - ph / 2, im_h),
                         clip(cx + pw / 2, im_w), clip(cy + ph / 2, im_h)],
                        dim=1)
    min_size = float(attrs["rpn_min_size"]) * info[0, 2]
    ok = ((boxes[:, 2] - boxes[:, 0] + 1 >= min_size)
          & (boxes[:, 3] - boxes[:, 1] + 1 >= min_size))
    keep = nms_keep(boxes[None], scores[None], ok[None],
                    float(attrs["threshold"]), post_n)[0]
    rank = torch.where(keep, scores, torch.full_like(scores, _NEG))
    top = stable_topk(rank, post_n)
    rois = torch.cat([torch.zeros((post_n, 1), device=dev), boxes[top]],
                     dim=1)
    if attrs["output_score"]:
        return rois, scores[top][:, None]
    return rois


# --- Correlation (reference src/operator/correlation.cc, FlowNet) -------------
@defop("Correlation", arg_names=("data1", "data2"),
       param_spec={"kernel_size": 1, "max_displacement": 1, "stride1": 1,
                   "stride2": 1, "pad_size": 0, "is_multiply": True})
def _correlation(attrs, data1, data2):
    """The cost volume of two (B, C, H, W) maps: for each displacement d
    of a (2 * max_displacement / stride2 + 1)^2 grid, the mean over the
    channels and the k x k window of data1 at a centre times (or, with
    ``is_multiply`` off, the absolute difference from) data2 at the centre
    moved by d; centres every ``stride1`` from the border
    max_displacement + kernel_size // 2 of the padded maps."""
    k = int(attrs["kernel_size"])
    md = int(attrs["max_displacement"])
    s1, s2 = int(attrs["stride1"]), int(attrs["stride2"])
    pad = int(attrs["pad_size"])
    rad = k // 2
    disp = [i * s2 for i in range(-(md // s2), md // s2 + 1)]
    p1 = F.pad(data1, (pad, pad, pad, pad))
    p2 = F.pad(data2, (pad, pad, pad, pad))
    ph, pw = p1.shape[2], p1.shape[3]
    border = md + rad
    out_h = len(range(border, ph - border, s1))
    out_w = len(range(border, pw - border, s1))
    if out_h == 0 or out_w == 0:
        raise MXNetError("Correlation: displacement/pad config leaves no "
                         "valid output positions")
    span_h, span_w = (out_h - 1) * s1 + 1, (out_w - 1) * s1 + 1

    def window(x, dy, dx):
        # the k x k windows at every centre: (B, C, k * k, out_h, out_w)
        y, xx = border + dy - rad, border + dx - rad
        return torch.stack([x[:, :, y + i:y + i + span_h:s1,
                              xx + j:xx + j + span_w:s1]
                            for i in range(k) for j in range(k)], dim=2)

    f1 = window(p1, 0, 0)
    maps = []
    for dy in disp:
        for dx in disp:
            f2 = window(p2, dy, dx)
            m = f1 * f2 if attrs["is_multiply"] else abs_(f1 - f2)
            maps.append(m.mean(dim=(1, 2)))
    return torch.stack(maps, dim=1)
