#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises (non-zero exit):

1. ``build``   — build every CUDA kernel from ``mxnet_tpu_torch/ops/kernels/
   csrc`` with nvcc for sm_90a (seconds, ptxas report, card name + limit).
2. ``kernel``  — each kernel against its plain PyTorch version on the card
   at the main paths' shapes, then timed (CUDA events, median) beside the
   plain version, one PyTorch library call where there is one, and the
   card's bound: the flash-attention forward (bf16 on wgmma + TMA, f32 on
   register tiles + cp.async: each instantiation's registers, shared memory
   and spills from ptxas, HGMMA / UTMALDG counts from its SASS, the tile
   edges, both types timed at the serve and train shapes with device times
   beside), the flash-attention backward (dQ and dK/dV kernels, the same
   two designs and report, both types timed at the train shape with device
   times beside SDPA autograd's; both also at the train phase's batch 32
   in bf16), the fused sgd_mom / adam updates (the device-lr entry points
   bit for bit the scalar ones and their plain versions), and the
   convolution weight gradient (conv_wgrad: bf16 on wgmma + TMA after a
   repack, f32 on register tiles + cp.async, a simt body for odd bf16
   shapes, and the reduction kernel; the same instantiation report, each
   case's route, the ResNet shapes held to the wgmma and f32 routes) at
   ResNet-50's seven 3x3 shapes and the reference oracle's odd cases,
   beside cuDNN's wgrad, with device times; and the LSTM step (lstm_step:
   f32 on register tiles + cp.async, bf16 on wgmma + TMA, a simt body for
   odd bf16 layouts; the same instantiation report, each case's route, the
   scan's main-path shapes held to the f32 and wgmma bodies) at the LSTM
   LM's shape, the bucketing run's (32, 512) and odd ones, on the views the
   RNN op passes, beside cuBLAS + PyTorch's fused LSTM cell and, for a
   whole layer, cuDNN's LSTM.
3. ``serve``   — the continuous-batching generate path at full width (the
   GQA decoder LM of ``bench.py``: d 2048, 16 heads, 4 kv heads, ffn 8192,
   vocab 10000, bench.py's own 4 layers (not cut), seeded random weights,
   f32; ``mxnet_tpu_torch/tools/lm.py``): six
   prompts through ``DecodeScheduler`` with four slots, so admissions
   happen mid-flight. Checks every stream, the kernel's launch count, and
   first-token logits against the port's plain path on the CPU.
4. ``train``   — the same LM trained as bench.py trains it: first 2 SGD
   steps at 1 x 256 through ``simple_bind`` -> ``forward``/``backward``
   -> ``optimizer.Updater``, f32, no TF32, on the card and on the port's
   CPU path from the same weights (losses and parameters must agree); the
   same 2 steps in bf16 through the fused step (``simple_bind(...,
   compute_dtype="bfloat16")`` -> ``make_train_step`` with the SGD
   ``pure_rule``), card against CPU: the loss within TRAIN_BF16_LOSS and
   the parameters within TRAIN_BF16_SPREAD times the CPU's bf16-to-f32
   distance, while the same step with the card in f32 (the control) must
   fail the loss gate; then the run: Xavier-initialized 5
   SGD-momentum + 3 Adam steps at 32 x 2048 (bench.py's batch), bf16,
   each optimizer's step one CUDA graph (two warm-up calls, a capture,
   replays), with exact launch counts of every kernel (flash forward,
   backward dQ and dK/dV, all in bf16; both updates' device-lr entries),
   10 more timed
   Adam steps; then the whole run again with the step eager, which must
   land on the same parameters bit for bit.
5. ``resnet``  — ResNet-50 (bench.py's headline model, full width, 1000
   classes, 3 x 224 x 224, no TF32; ``mxnet_tpu_torch/tools/
   resnet.py``) trained through ``Module.fit``: first 2 batches of 2 in
   f32 on the card and on the port's CPU path from the same Xavier
   weights (updates, aux states and metrics must agree), then one epoch
   of 8 seeded batches of 32 in bf16 (bench.py's compute type) through
   the captured fused ``fit_step``, with exact launch counts (conv_wgrad
   partial (all bf16), reduce and repack, sgd_mom), finite cross-entropy,
   step
   times, images/s and peak memory; then the epoch again with the fused
   step eager (``MXNET_CUDA_GRAPH=0``): parameters and aux states equal
   bit for bit.
6. ``lstm``    — the fused 2-layer LSTM LM (the repo's widest LSTM record:
   vocab 10000, embed = hidden = 512, seq 35, f32, no TF32;
   ``mxnet_tpu_torch/tools/lstm_lm.py``) trained through ``Module.fit``:
   first 2 batches of 8 on the card and on the port's CPU path from the same
   Xavier weights (each parameter's update and the perplexity must agree),
   then one epoch of 8 seeded batches of 128 through the captured fused
   ``fit_step`` and ``Module.score`` over the same batches, with exact
   ``lstm_step`` launch counts in each (2 layers x 35 steps x 8), finite
   perplexity, step times, tokens/s and peak memory; then the epoch again
   with the step eager, equal bit for bit; before it, a line naming what
   holds the card's memory.
7. ``kernel`` rtc — ``mx.rtc``: the JAX package's rtc test kernels (axpy,
   inc, relu, axpy in bf16) as CUDA C compiled by NVRTC, each against its
   mode="torch" twin; the source cache; a syntax error and a refused
   launch raising; the ``rtc_softmax`` forward and backward kernels
   (``mxnet_tpu_torch/tools/rtc_softmax.py``; the backward's vector and
   scalar sources) against their twins at the LSTM LM's (4480, 10000) and
   odd shapes, each case's backward route named, timed beside the twins,
   ``torch.softmax`` and ``torch.scatter_add``, with the NVRTC compile ms.
8. ``custom``  — the LSTM LM of phase 6 with a Custom ``rtc_softmax`` head
   (forward and backward rtc kernels) through ``Module.fit``: (a) card
   vs the port's CPU path (2 batches of 8), (b) the rtc head vs the
   built-in ``SoftmaxOutput`` head on the card (2 batches of 128), both
   at the lstm phase's gates; (c) 8 batches of 128 through the captured
   fused ``fit_step`` (the rtc kernels inside the graph) and
   ``Module.score`` with exact launch counts (rtc fwd 8 + 8, bwd 8 + 0,
   lstm_step 560 + 560), finite perplexity, step times, tokens/s and peak
   memory; then the 8 batches again with the step eager, equal bit for
   bit.
9. ``bucketing`` — the same LSTM LM as MXNet's ``lstm_bucketing.py``
   trains it (``mxnet_tpu_torch/tools/lstm_bucketing.py``: buckets
   10..60, batch 32, dropout 0.5 between the layers, SGD lr 0.01 / wd
   1e-5 / momentum 0.9, a seeded Markov corpus) through
   ``BucketingModule``: (1) card vs the port's CPU path at p = 0 (the two
   devices' generators draw different masks), 2 batches of 8 in bucket
   10 and 2 in 60, at the lstm phase's gates; (2) one epoch (>= 24
   batches, every bucket twice or more) with ``do_checkpoint`` and
   ``module_checkpoint(save_optimizer_states=True)`` at its end, then
   ``score``, with exact launches (lstm_step 2 x the epoch's summed
   bucket lengths, f32 only; sgd_mom_update 4 x batches), eager step ms
   by bucket, tokens/s and peak memory; (3) a fresh BucketingModule from
   the checkpoint and its optimizer states against the uninterrupted
   one, 4 batches after the same seed: bit for bit; (4) dropout on the
   card: eval at p = 0.5 equals p = 0 bit for bit, seeds repeat and
   differ, a 2^20-element mask keeps 0.5 +- 5 sigma, each kept entry
   x / (1 - p) exactly; (5) ``Module.fit`` at seq 35 with dropout through
   the captured step against its eager twin, bit for bit, and two more
   replays on one batch, which must differ.
10. ``kernels`` — one line per the port's kernel table.

Then the card's ``nvidia-smi`` name/power-limit line and, last, the
``{"ok": true, "device": ...}`` line. Exits non-zero without a CUDA card.
"""
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

from mxnet_tpu_torch.tools.lm import LM, SERVE, SEED, TRAIN, \
    lm_arg_params, lm_feed, lm_param_shapes, lm_train_executor, \
    cuda_graph, lm_train_setup, lm_train_step, lm_update, lm_updater, \
    nvidia_smi
from mxnet_tpu_torch.tools.lstm_lm import LSTM_LM, STEP_SHAPES, STEP_TOL, \
    lstm_setup, lstm_steps
from mxnet_tpu_torch.tools.lstm_lm import fit_args as lstm_fit_args
from mxnet_tpu_torch.tools import lstm_bucketing as lb
from mxnet_tpu_torch.tools.lstm_bucketing import BUCKETING
from mxnet_tpu_torch.tools.resnet import RESNET, change_err, fit_args, \
    resnet_setup, wgrad_convs

H100 = {"bf16_flops": 989e12, "f32_flops": 67e12, "bytes_per_s": 3.35e12}
CSRC = "mxnet_tpu_torch/ops/kernels/csrc/"
FA_SRC = CSRC + "flash_attention_fwd.cu"
FA_REPLACES = "mxnet_tpu/ops/pallas/flash_attention.py:259"
# the forward's instantiations: __global__ name -> the type it runs
FA_KERNELS = {"flash_fwd_wgmma_kernel": "bfloat16",
              "flash_fwd_f32_kernel": "float32"}
# SASS opcodes a bf16 instantiation must contain: wgmma and TMA loads
FA_BF16_OPCODES = ("HGMMA", "UTMALDG")
FA_BWD_SRC = CSRC + "flash_attention_bwd.cu"
FA_BWD_REPLACES = "mxnet_tpu/ops/pallas/flash_attention.py:618"
# the backward's instantiations: a dQ and a dK/dV kernel per type
FA_BWD_KERNELS = {"flash_bwd_dq_wgmma_kernel": "bfloat16",
                  "flash_bwd_dkv_wgmma_kernel": "bfloat16",
                  "flash_bwd_dq_f32_kernel": "float32",
                  "flash_bwd_dkv_f32_kernel": "float32"}
# flops per visible (query, key) pair, head and head-dim element of one
# backward: the bound's (q.k, dO.v and the three products), and what the
# two kernels do (S and dP again in the dQ kernel; in bf16 also the lo
# parts of P and dS)
FA_BWD_WORK = {"bound": 10, "float32": 14, "bfloat16": 20}
UPDATE_SRC = CSRC + "fused_update.cu"
UPDATE_REPLACES = {"sgd_mom_update": "mxnet_tpu/ops/pallas/fused_update.py:31",
                   "adam_update": "mxnet_tpu/ops/pallas/fused_update.py:60"}
WGRAD_SRC = CSRC + "conv_wgrad.cu"
WGRAD_REPLACES = "mxnet_tpu/ops/pallas/conv_bwd.py:89"
# conv_wgrad's templated partial kernels (on bn, the columns of K a block)
# and the type each runs; the simt and reduce kernels are not templated
WGRAD_KERNELS = {"conv_wgrad_wgmma_kernel": "bfloat16",
                 "conv_wgrad_f32_kernel": "float32",
                 "conv_wgrad_f32tap_kernel": "float32"}
LSTM_SRC = CSRC + "lstm_step.cu"
LSTM_REPLACES = "mxnet_tpu/ops/pallas/lstm.py:35"
# lstm_step's templated bodies: __global__ name -> (the type it runs, its
# instantiations' template arguments); the simt body is reported only
LSTM_KERNELS = {"lstm_f32_kernel": ("float32", (64, 16)),
                "lstm_wgmma_kernel": ("bfloat16", (8,))}
LSTM_SIMT = "lstm_simt_kernel"
# the (N, H) the scan runs at in the lstm phases, and lstm_step's kernel vs
# plain (atol, rtol): both with their reasons in tools/lstm_lm.py
LSTM_MAIN, LSTM_TOL = STEP_SHAPES, STEP_TOL
# (atol, rtol); bf16 outputs differ by an ulp of |O| (rtol), while atol
# stays below |O| ~ sqrt(e / T) of the long rows
TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-3, 2e-2)}
# flash backward (atol, rtol) per gradient. f32: dQ as the forward; dK/dV
# sum G * Tq (up to 8192) products per element in another order than the
# plain einsum, so atol 5e-4. bf16: one bf16 ulp of the result (rtol), and
# an atol far below the typical |dQ| / |dK| / |dV| the phase prints.
BWD_TOL = {"float32": {"dq": (2e-4, 2e-4), "dk": (5e-4, 2e-4),
                       "dv": (5e-4, 2e-4)},
           "bfloat16": {"dq": (2e-3, 2e-2), "dk": (5e-3, 2e-2),
                        "dv": (5e-3, 2e-2)}}
# fused updates (atol, rtol): the kernel may contract a*b+c into one FMA
# where the plain version rounds twice: a last-bit difference of f32, an
# ulp of bf16
UPDATE_TOL = {"float32": (1e-6, 1e-5), "bfloat16": (1e-2, 2e-2)}
# train phase, card vs the port's CPU path after 2 SGD steps at 1 x 256:
# losses within 1e-4 relative; parameters within 1e-5 absolute — f32
# gradients whose sums run in other orders (cuBLAS vs the CPU's GEMM, the
# flash kernels vs the plain einsums) differ in the last bits, scaled by
# lr 0.05 and momentum into the weights
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-5
# train phase, the bf16 fused step at the same size, card vs the port's
# CPU path in bf16: the two round to bf16 at the same places but from sums
# in other orders, so a value near a rounding point lands an ulp apart,
# as the CPU's bf16 lands from its f32. The losses and the parameters must
# lie within TRAIN_BF16_SPREAD times the CPU's own bf16-to-f32 distance
# (tools/train_bf16_spread.py measures both distances on the CPU). A card
# that computed the step in f32 would lie that distance from the CPU's
# bf16, 1x, and the parameters' distance is an ulp of the largest weights
# either way, so it cannot tell the two apart; the losses can: the sound
# card reads 0.30x (PERF.md), the f32 control 1.0x. So the losses are
# held to TRAIN_BF16_LOSS times the distance, between the two, and the
# phase runs the control through the same comparison: it must fail
TRAIN_BF16_SPREAD = 1.5
TRAIN_BF16_LOSS = 0.6
# conv_wgrad, kernel vs plain: max |error| / max |plain dW|. Both sum the
# same f32 products (bf16 operands widen exactly) over L = N*OH*OW, up to
# 100,352 terms, in other orders: a few f32 ulps of the largest sums
WGRAD_RTOL = 2e-5
# (input H, C = K, stride) of ResNet-50's 3x3 convolutions -> how many of
# each one step runs (3 + 1 + 3 + 1 + 5 + 1 + 2 = 16)
RESNET_WGRAD = {(56, 64, 1): 3, (56, 128, 2): 1, (28, 128, 1): 3,
                (28, 256, 2): 1, (14, 256, 1): 5, (14, 512, 2): 1,
                (7, 512, 1): 2}
# resnet phase, card vs the port's CPU path (ResNet-50, 2 batches of 2).
# A randomly initialized ResNet-50 at batch 2 is chaotic under rounding:
# a ReLU input within rounding of 0 takes the other branch, and batch
# norm's backward spreads that element over its channel, so the first
# update already differs by percents between any two f32 orders of
# summation, and the second starts from those different weights
# (tools/resnet_spread.py measures f32 against f64 on the CPU). So the
# gates are: after batch 1, each parameter's update within RESNET_UPDATE
# of the CPU's (L2 norm of the difference over the norm of the update), each
# aux state's change within RESNET_AUX, the cross-entropy within
# RESNET_CE[0] (relative) and the accuracy equal; after batch 2 the
# cross-entropy within RESNET_CE[1]. The batch-2 updates are printed.
RESNET_UPDATE = 0.15
RESNET_AUX = 2e-3
RESNET_CE = (1e-4, 1e-2)
# the 35-step scan through the kernel vs the plain scan, f32: the step's
# last-bit differences carried through 35 recurrences
LSTM_SCAN_TOL = (1e-4, 1e-4)
# (N, H) of lstm_step: the LSTM LM's batch 128 and its check's batch 8 at
# H 512, the bucketing run's batch 32, bench_lstm.py's default (32, 256),
# and two shapes the reference's use_for refuses (H not a multiple of 128,
# N not of 8); 200 is lstm-lm's default width
LSTM_CASES = ((128, 512), (8, 512), (32, 512), (32, 256), (4, 8), (3, 200))
# the bucketing phase's step: (batch, hidden), f32, in the scan's layout
BUCKET_STEP = (BUCKETING["batch"], BUCKETING["hidden"])
# lstm phase, card vs the port's CPU path (the LSTM LM, 2 batches of 8):
# after each batch, each parameter's update within LSTM_UPDATE (L2 norm of
# the difference over the norm of the CPU's update) and the perplexity
# within LSTM_PPL (relative). The LSTM has no ReLU ties: f32 against f64 on
# the CPU (tools/lstm_spread.py) moves the updates by at most 6.5e-6 and
# the perplexity by 7e-9, so the gates leave 15x and 100x of room for two
# f32 orders of summation while a wrong kernel moves updates by order 1
LSTM_UPDATE = 1e-4
LSTM_PPL = 1e-6
RTC_SRC = "mxnet_tpu_torch/tools/rtc_softmax.py"
RTC_REPLACES = "mxnet_tpu/rtc.py:77"
# mx.rtc test kernels (the JAX package's tests' axpy, inc and relu, and axpy
# in bf16) in CUDA C: the kernel body of each and its mode="torch" twin.
# Each body runs with ``N`` (the element count) and ``i`` (the thread's
# element) defined; see rtc_elementwise_src
RTC_ELEMENTWISE = {
    "axpy": (("x", "y"), "out[i] = x[i] * 2.0f + y[i];",
             "def fn(x, y):\n    return x * 2.0 + y\n", "float32"),
    "inc": (("x",), "out[i] = x[i] + 1.0f;",
            "def fn(x):\n    return x + 1.0\n", "float32"),
    "relu": (("x",), "out[i] = fmaxf(x[i], 0.0f);",
             "def fn(x):\n    return torch.clamp(x, min=0.0)\n", "float32"),
    "axpy_bf16": (("x", "y"), "out[i] = __float2bfloat16("
                  "__bfloat162float(x[i]) * 2.0f + __bfloat162float(y[i]));",
                  "def fn(x, y):\n"
                  "    return (x.float() * 2.0 + y.float()).to(torch.bfloat16)"
                  "\n", "bfloat16")}
# the shapes each test kernel runs at: the JAX tests' (8, 16), and one of
# many blocks
RTC_ELEMENTWISE_SHAPES = ((8, 16), (1024, 1000))
# test kernels vs their twins (rtol): f32 the same one-rounding arithmetic
# (x * 2 is exact), so within 1e-6 relative; bf16 within one bf16 ulp,
# which is at most 2^-7 of |x|
RTC_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
# rtc_softmax kernels vs their twins on probabilities and gradients in
# [-1, 1]: a sum of up to 10000 exps in another order differs by a few f32
# ulps of the sum, so each value within 1e-6 absolute and, since most of
# the LM's probabilities are near 1e-6 themselves, within 1e-5 relative
# (above a 1e-9 floor); and each row of probabilities sums to 1 within 1e-5
# (summed in f64). The backward copies p and subtracts 1 in f32 on both
# sides, so it agrees exactly
RTC_SOFTMAX_ATOL = 1e-6
RTC_SOFTMAX_RTOL = 1e-5
RTC_SOFTMAX_FLOOR = 1e-9
RTC_SOFTMAX_ROW_SUM = 1e-5
# (rows, classes) of rtc_softmax: the LSTM LM's 128 x 35 rows over its
# 10000 classes, a narrower head, one row, and a row narrower than a warp
RTC_SOFTMAX_CASES = ((4480, 10000), (128, 1000), (1, 10000), (3, 7))
# the backward's route (rtc_softmax.bwd_plan) these cases must take: the
# LM's head the vector source, a row of 7 the scalar one
RTC_BWD_ROUTES = {(4480, 10000): "vector", (3, 7): "scalar"}


def flash_cases():
    """Cases (b, h, hkv, tq, tk, d, causal, dtype, layout) of both flash
    kernels (layouts: see :func:`_randn`): the serve and train shapes (T up
    to 2048 at batch 1, and the training shape at batch 4), each as
    (B, T, H, D)-storage views like those ``MultiHeadAttention`` passes;
    MHA; tq < tk; head_dim 64. Then the edges of the forward's tiles (128
    query rows; 128 bf16 or 64 f32 keys): lengths of 1, 63, 65, 129 and
    2047, a ragged causal tq < tk, head_dim 64 at a length no multiple of
    128, B * H = 64, and rows whose T stride is no multiple of 16 bytes
    (the forward wrapper copies them). Last, the train phase's own case
    (:func:`train_main_case`, bf16 at batch 32)."""
    cases = []
    for dtype in ("float32", "bfloat16"):
        cases += [(1, 16, 4, t, t, 128, True, dtype, True)
                  for t in (128, 512, 1000, 2048)]
        cases += [(1, 16, 4, 2048, 2048, 128, True, dtype, False),
                  (4, 16, 4, 2048, 2048, 128, True, dtype, False),
                  (1, 16, 16, 512, 512, 128, False, dtype, True),
                  (1, 16, 4, 300, 1000, 128, True, dtype, True),
                  (2, 8, 2, 777, 777, 64, True, dtype, True)]
        cases += [(1, 16, 4, t, t, 128, True, dtype, True)
                  for t in (1, 63, 65, 129, 2047)]
        cases += [(2, 16, 4, 129, 515, 128, True, dtype, False),
                  (1, 16, 4, 1000, 1000, 64, True, dtype, False),
                  (4, 16, 4, 256, 256, 128, True, dtype, True),
                  (1, 16, 4, 300, 300, 128, True, dtype, "padded")]
    return cases + [train_main_case()]


def train_main_case():
    """The flash case of the train phase's main path: its batch and
    length, the LM's heads, its type, the (B, T, H, D) views."""
    return (TRAIN["batch"], LM["heads"], LM["kv_heads"], TRAIN["seq"],
            TRAIN["seq"], LM["d_model"] // LM["heads"], True, TRAIN["dtype"],
            False)


def emit(obj):
    print(json.dumps(obj), flush=True)


# --- bounds and timing -------------------------------------------------------
def attention_bound(b, h, hkv, tq, tk, d, causal, dtype):
    """Least time (ms) for one forward on the card, and what bounds it:
    4*D flops per visible (query, key) pair and head (QK^T and PV, the
    causal count exact), and q/k/v read plus o written once each."""
    flops = 4 * b * h * d * visible_pairs(tq, tk, causal)
    item = 4 if dtype == "float32" else 2
    nbytes = item * (2 * b * h * tq * d + 2 * b * hkv * tk * d)
    peak = H100["f32_flops"] if dtype == "float32" else H100["bf16_flops"]
    t_ops, t_bytes = flops / peak, nbytes / H100["bytes_per_s"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def visible_pairs(tq, tk, causal):
    """(query, key) pairs a causal (offset tk - tq) or full mask keeps."""
    if not causal:
        return tq * tk
    return int(np.minimum(tk, np.arange(tq) + (tk - tq) + 1).sum())


def attention_bwd_bound(b, h, hkv, tq, tk, d, causal, dtype, per_pair=10):
    """Least time (ms) for one flash backward, and what bounds it: 10*D
    flops per visible pair and head (q.k recomputed, dO.v, and the
    products into dQ, dK, dV), and q/k/v/o/dO read, dQ/dK/dV written
    once, plus the f32 lse read. ``per_pair`` = 14 or 20 gives the least
    time of the work the kernels do (``FA_BWD_WORK``)."""
    flops = per_pair * b * h * d * visible_pairs(tq, tk, causal)
    item = 4 if dtype == "float32" else 2
    nbytes = item * (4 * b * h * tq * d + 4 * b * hkv * tk * d) \
        + 4 * b * h * tq
    peak = H100["f32_flops"] if dtype == "float32" else H100["bf16_flops"]
    t_ops, t_bytes = flops / peak, nbytes / H100["bytes_per_s"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def update_bound(kind, elements, item=4):
    """Least time (ms) for one update pass over ``elements``: each reads
    w, g and the state(s) once and writes w and the state(s) once."""
    per = {"sgd_mom_update": 5, "adam_update": 7}[kind] * item
    return elements * per / H100["bytes_per_s"] * 1e3, "bytes"


def wgrad_bound(n, h, c, k, ksz, stride, dtype):
    """Least time (ms) for one dW of a (ksz, stride, SAME pad) conv: 2 flops
    per (output position, c, k, tap), and x and dy read plus dW (f32)
    written once."""
    oh = (h + 2 * ((ksz - 1) // 2) - ksz) // stride + 1
    flops = 2 * n * oh * oh * c * k * ksz * ksz
    item = 4 if dtype == "float32" else 2
    nbytes = item * (n * h * h * c + n * oh * oh * k) + 4 * ksz * ksz * c * k
    peak = H100["f32_flops"] if dtype == "float32" else H100["bf16_flops"]
    t_ops, t_bytes = flops / peak, nbytes / H100["bytes_per_s"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def lstm_step_bound(n, h, dtype):
    """Least time (ms) for one LSTM step, and what bounds it: 2 flops per
    (row, gate row, k) of h . Wh^T, and ib, h, c, Wh read plus h', c'
    written once."""
    flops = 2 * n * 4 * h * h
    item = 4 if dtype == "float32" else 2
    nbytes = item * (n * 4 * h + 2 * n * h + 4 * h * h + 2 * n * h)
    peak = H100["f32_flops"] if dtype == "float32" else H100["bf16_flops"]
    t_ops, t_bytes = flops / peak, nbytes / H100["bytes_per_s"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def lstm_layer_bound(t, n, i, h):
    """Least time (ms) for one f32 LSTM layer over t steps: the input
    projection and the t recurrent products, x, the weights and biases
    and h0 / c0 read and the outputs and final states written once."""
    flops = 2 * t * n * 4 * h * (i + h)
    nbytes = 4 * (t * n * i + 4 * h * (i + h) + 8 * h + 2 * n * h
                  + t * n * h + 2 * n * h)
    t_ops, t_bytes = (flops / H100["f32_flops"],
                      nbytes / H100["bytes_per_s"])
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rtc_softmax_bound(rows, cols):
    """Least time (ms) of one rtc_softmax forward (or backward) at (rows,
    cols) f32: the logits (probabilities) read and the probabilities
    (gradients) written once; the backward's labels add rows * 4 bytes."""
    return 2 * 4 * rows * cols / H100["bytes_per_s"] * 1e3, "bytes"


def rtc_elementwise_src(body, n):
    """A test kernel's CUDA body over ``n`` elements: one thread each."""
    return ("const int N = %d;\n"
            "const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
            "if (i < N) { %s }\n" % (n, body))


def time_ms(torch, fn, reps=30, warmup=3):
    """Median of ``reps`` single-call CUDA-event timings."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _device_events(torch, fn, reps, warmup, calls=None):
    """The CUDA events of a ``torch.profiler`` trace of ``reps`` calls of
    ``fn()``, after ``warmup`` untraced ones. A trace that shows no device
    time, or (``calls``: {name part: launches a call}) fewer or more
    launches of a kernel than ``fn`` makes, lost events: it is taken
    again, three times at most."""
    prof_mod = torch.profiler
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with prof_mod.profile(activities=[prof_mod.ProfilerActivity.CPU,
                                          prof_mod.ProfilerActivity.CUDA]) \
                as p:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in p.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = {part: sum(e.count for e in events if part in e.key)
                for part in (calls or {})}
        if sum(e.self_device_time_total for e in events) > 0 and \
                all(seen[part] == n * reps for part, n in (calls or
                                                           {}).items()):
            return events
    raise RuntimeError("the profiler saw no device time, or lost launches "
                       "(%s of %s a call)" % (seen, calls))


def device_ms(torch, fn, reps=20, warmup=3):
    """Device time (ms) of one ``fn()`` call: the summed time of every
    kernel it launches, from a ``torch.profiler`` trace of ``reps`` calls.
    Unlike :func:`time_ms` it leaves out the gaps while the host enqueues,
    which dominate a call whose kernels take microseconds."""
    events = _device_events(torch, fn, reps, warmup)
    return sum(e.self_device_time_total for e in events) / reps / 1e3


def device_ms_by(torch, fn, by, reps=20, warmup=3, calls=None):
    """:func:`device_ms` of one ``fn()`` call, and {label: ms} of the
    kernels whose names hold ``by[label]``; ``calls`` as for
    :func:`_device_events`."""
    events = _device_events(torch, fn, reps, warmup, calls)
    return (sum(e.self_device_time_total for e in events) / reps / 1e3, {
        label: sum(e.self_device_time_total for e in events
                   if part in e.key) / reps / 1e3
        for label, part in by.items()})


def loop_ms(torch, fn, calls=20, reps=10, warmup=2):
    """Median CUDA-event time (ms) of one ``fn()`` call, from runs of
    ``calls`` calls back to back: for kernels longer than the host's
    enqueue the queue stays full, so the host's time per call drops out."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def graph_ms(torch, fn, calls=35, reps=20):
    """Median CUDA-event time (ms) of one ``fn()`` call, from replays of a
    CUDA graph of ``calls`` calls (a scan's 35 steps): the host's enqueue
    stays out of the timed region, the device's gaps between kernels stay
    in."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(torch, graph.replay, reps) / calls


def _times(torch, fns, reps=20):
    """{name: device ms} of each (name, fn), and {name: CUDA-event ms}
    of single calls, the host's enqueue included."""
    return ({k: device_ms(torch, f, reps) for k, f in fns},
            {k: time_ms(torch, f, reps) for k, f in fns})


# --- phases ------------------------------------------------------------------
def phase_build():
    from mxnet_tpu_torch.ops.kernels import _build

    t0 = time.time()
    paths = _build.build_all()
    emit({"phase": "build", "seconds": time.time() - t0,
          "libraries": {k: os.path.relpath(v) for k, v in paths.items()},
          "nvcc": _build.nvcc(),
          "ptxas": {k: [ln for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in _build.build_log.items()},
          "gpu": nvidia_smi()})


# the layouts of _randn, by name
LAYOUTS = {True: "bhtd", False: "bthd view",
           "padded": "bhtd view, rows padded to D + 1"}


def _randn(torch, b, heads, t, d, dtype, gen, layout=True):
    """A seeded (b, heads, t, d) tensor. ``layout`` True: contiguous;
    False: (B, T, H, D) storage seen through ``transpose(1, 2)``, the
    strided views prefill and ``MultiHeadAttention`` pass; "padded":
    (b, heads, t, d + 1) storage cut to d, whose T stride is no multiple
    of 16 bytes."""
    dt = getattr(torch, dtype)
    if layout == "padded":
        return torch.randn(b, heads, t, d + 1, generator=gen,
                           device="cuda").to(dt)[..., :d]
    if layout:
        return torch.randn(b, heads, t, d, generator=gen, device="cuda").to(dt)
    return torch.randn(b, t, heads, d, generator=gen,
                       device="cuda").to(dt).transpose(1, 2)


def _qkv(torch, b, h, hkv, tq, tk, d, dtype, gen, layout=True):
    """Seeded q/k/v in ``layout`` (see _randn)."""
    return (_randn(torch, b, h, tq, d, dtype, gen, layout),
            _randn(torch, b, hkv, tk, d, dtype, gen, layout),
            _randn(torch, b, hkv, tk, d, dtype, gen, layout))


def ptxas_report(log, names):
    """{"<name><D>": {"registers", "smem_static", "stack", "spill_stores",
    "spill_loads"}} of each instantiation of the ``__global__`` functions
    ``names`` (templated on one int), parsed from ``nvcc -Xptxas -v``
    output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            cur = kernel_label(m.group(1), names)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.setdefault(cur, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(cur, {}).update(
                registers=int(m.group(1)),
                smem_static=int(smem.group(1)) if smem else 0)
    return out


def kernel_label(mangled, names):
    """``name<D>`` (``name<A,B>`` for several int template arguments) for
    a mangled instantiation of one of ``names``, else None."""
    for name in names:
        m = re.search(name + r"I((?:Li\d+E)+)E", mangled)
        if m:
            return "%s<%s>" % (name, ",".join(
                re.findall(r"Li(\d+)E", m.group(1))))
    return None


def sass_counts(lib, names, opcodes):
    """{"<name><D>": {opcode: count}} in the SASS of library ``lib``
    (``cuobjdump -sass``, from PATH or ``$CUDA_HOME/bin``)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    return sass_opcode_counts(sass, names, opcodes)


def sass_opcode_counts(sass, names, opcodes):
    """The counting of :func:`sass_counts` over cuobjdump's text."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = kernel_label(m.group(1), names)
            if cur is not None:
                out[cur] = dict.fromkeys(opcodes, 0)
            continue
        if cur is not None:
            for op in opcodes:
                if re.search(r"\b%s\b" % op, line):
                    out[cur][op] += 1
    return out


def wgmma_serialized(log, names):
    """{"<name><D>": count} of ptxas's C7515 / C7520 notes ("wgmma ...
    serialized") naming each instantiation of ``names`` in ``log``."""
    out = {}
    for line in log.splitlines():
        if "wgmma" not in line or not re.search(r"C75(15|20)", line):
            continue
        m = re.search(r"'(_Z\w+)'", line)
        label = kernel_label(m.group(1), names) if m else None
        if label is not None:
            out[label] = out.get(label, 0) + 1
    return out


def instantiation_report(log, sass, kernels, head_dims, smem_of):
    """Each instantiation of ``kernels`` ({__global__ name: dtype}) at each
    head dim: its registers, shared memory (static from the ptxas ``log``,
    dynamic from ``smem_of(name, dtype, d)``), spills, ptxas's wgmma
    serialization notes and its HGMMA / UTMALDG counts (``sass``, from
    :func:`sass_opcode_counts`). Fails when an instantiation is missing
    from the log, a bf16 one lacks wgmma or TMA loads, or an f32 one
    spills."""
    names = tuple(kernels)
    ptxas = ptxas_report(log, names)
    serial = wgmma_serialized(log, names)
    report = {}
    for name, dtype in kernels.items():
        for d in head_dims:
            label = "%s<%s>" % (name, d)
            row = dict(ptxas.get(label, {}), dtype=dtype,
                       smem_dynamic=smem_of(name, dtype, d),
                       sass=sass.get(label, {}),
                       wgmma_serialized=serial.get(label, 0))
            if "registers" not in row:
                raise RuntimeError("no ptxas report for %s" % label)
            if dtype == "bfloat16" and not all(
                    row["sass"].get(op, 0) > 0 for op in FA_BF16_OPCODES):
                raise RuntimeError("%s lacks %s in its SASS: %s"
                                   % (label, FA_BF16_OPCODES, row["sass"]))
            if dtype == "float32" and (row["spill_stores"]
                                       or row["spill_loads"]):
                raise RuntimeError("%s spills: %s" % (label, row))
            report[label] = row
    return report


def flash_report(lib, kernels, smem_of):
    """:func:`instantiation_report` of library ``lib``'s build log and
    SASS (``cuobjdump``)."""
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    sass = sass_counts(_build.lib_path(lib), tuple(kernels), FA_BF16_OPCODES)
    return instantiation_report(_build.log_of(lib), sass, kernels,
                                fa.HEAD_DIMS, smem_of)


def flash_fwd_report(torch):
    """The forward's instantiations (:func:`instantiation_report`)."""
    import ctypes

    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    smem = _build.kernel(fa._NAME, "mxtt_flash_attention_fwd_smem",
                         [ctypes.c_int, ctypes.c_int])
    return flash_report(fa._NAME, FA_KERNELS, lambda name, dtype, d:
                        smem(fa._DTYPE_CODE[getattr(torch, dtype)], d))


def flash_bwd_report(torch):
    """The backward's instantiations, dQ and dK/dV per type
    (:func:`instantiation_report`)."""
    import ctypes

    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    smem = _build.kernel(fa._BWD_NAME, "mxtt_flash_attention_bwd_smem",
                         [ctypes.c_int] * 3)
    return flash_report(fa._BWD_NAME, FA_BWD_KERNELS,
                        lambda name, dtype, d: smem(
                            0 if "_dq_" in name else 1,
                            fa._DTYPE_CODE[getattr(torch, dtype)], d))


def phase_kernel(torch):
    """Flash forward: its instantiations' build and SASS report; kernel vs
    plain on the card, without the lse (the serve path's call) and with it
    (the train path's); then timings of both types at the serve and the
    train shape, in the (B, T, H, D) views those paths pass."""
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    instantiations = flash_fwd_report(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results, worst, main_err = [], {}, None
    for case in flash_cases():
        b, h, hkv, tq, tk, d, causal, dtype, layout = case
        q, k, v = _qkv(torch, b, h, hkv, tq, tk, d, dtype, gen, layout)
        copied = any(fa.tensor_map_plan(t)[1] for t in (q, k, v))
        if copied != (layout == "padded"):
            raise RuntimeError("layout %s: the wrapper would%s copy"
                               % (LAYOUTS[layout], "" if copied else " not"))
        got = fa.flash_attention(q, k, v, causal=causal)
        o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        want, want_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                                  return_lse=True)
        torch.cuda.synchronize()
        errs = []
        atol, rtol = TOL[dtype]
        for g, w in ((got, want), (o, want), (lse, want_lse)):
            torch.testing.assert_close(g.float(), w.float(),
                                       atol=atol, rtol=rtol)
            errs.append(float((g.float() - w.float()).abs().max()))
        results.append({"shape": [b, h, hkv, tq, tk, d], "causal": causal,
                        "dtype": dtype, "layout": LAYOUTS[layout],
                        "copied": copied, "atol": atol, "rtol": rtol,
                        "max_abs_err": {"o": errs[0], "o_with_lse": errs[1],
                                        "lse": errs[2]}})
        worst[dtype] = max([worst.get(dtype, 0.0)] + errs)
        if case == train_main_case():
            main_err = results[-1]["max_abs_err"]
        del q, k, v, got, o, lse, want, want_lse
        torch.cuda.empty_cache()

    timings = {}
    # serve, train at batch 4 (the rows of earlier PRs), and the train
    # phase's own batch in its type (bf16)
    for where, b, dtypes in (("serve", 1, ("float32", "bfloat16")),
                             ("train", 4, ("float32", "bfloat16")),
                             ("train_main", TRAIN["batch"],
                              (TRAIN["dtype"],))):
        timings[where] = {}
        for dtype in dtypes:
            h, hkv, t, d = 16, 4, 2048, 128
            q, k, v = _qkv(torch, b, h, hkv, t, t, d, dtype, gen, False)
            bound_ms, bound_by = attention_bound(b, h, hkv, t, t, d, True,
                                                 dtype)
            kernel = functools.partial(fa.flash_attention, q, k, v,
                                       causal=True)
            library = _sdpa(torch, q, k, v)
            timings[where][dtype] = {
                "shape": [b, h, hkv, t, t, d], "causal": True,
                "layout": LAYOUTS[False],
                "ms": time_ms(torch, kernel),
                "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
                    q, k, v, causal=True), reps=10),
                "library_ms": time_ms(torch, library),
                # the kernels alone, without the host's enqueue
                "device_ms": device_ms(torch, kernel),
                "library_device_ms": device_ms(torch, library),
                "bound_ms": bound_ms, "bound_by": bound_by}
            del q, k, v
            torch.cuda.empty_cache()
    timings["train_main"][TRAIN["dtype"]]["main_path_max_abs_err"] = main_err
    emit({"phase": "kernel", "kernel": "flash_attention_fwd",
          "instantiations": instantiations, "cases": results,
          "max_abs_err": worst, "timings": timings})
    return worst, timings


def _sdpa(torch, q, k, v):
    """The library yardstick: one scaled_dot_product_attention call (GQA
    native from torch 2.5; before that the kv heads are repeated up front,
    outside the timed call). Timed only; the port never calls it."""
    F = torch.nn.functional
    major, minor = (int(x) for x in torch.__version__.split(".")[:2])
    if (major, minor) >= (2, 5):
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
    g = q.shape[1] // k.shape[1]
    kr, vr = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    return lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True)


def _sdpa_bwd(torch, q, k, v, do):
    """The library yardstick of the backward: autograd through one
    :func:`_sdpa` call, the graph kept between calls. Timed only; the
    port never calls it."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = _sdpa(torch, *leaves)()
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def bwd_timing(torch, shape, dtype, kernel, plain, library,
               timers=(time_ms, device_ms, device_ms_by)):
    """One timing row of the backward at ``shape`` (b, h, hkv, t, d,
    causal): single calls of the kernel pair (``kernel``), of the plain
    version and of the library yardstick (CUDA events, the host's enqueue
    included), the device times of the whole call (the torch pass for D
    included; the dQ and dK/dV kernels apart) and of the library's, beside
    the bound. ``work`` holds the least time of the work the kernels do
    (``FA_BWD_WORK``): this phase's line shows it, the kernels line not."""
    single, device, device_by = timers
    b, h, hkv, t, d, causal = shape
    bound_ms, bound_by = attention_bwd_bound(b, h, hkv, t, t, d, causal,
                                             dtype)
    work_ms, _ = attention_bwd_bound(b, h, hkv, t, t, d, causal, dtype,
                                     FA_BWD_WORK[dtype])
    dev, parts = device_by(torch, kernel, {"dq": "flash_bwd_dq",
                                           "dkv": "flash_bwd_dkv"})
    return {"shape": [b, h, hkv, t, t, d], "causal": causal,
            "layout": LAYOUTS[False],
            "ms": single(torch, kernel, reps=10),
            "plain_ms": single(torch, plain, reps=10),
            "library_ms": single(torch, library, reps=10),
            "device_ms": dev, "device_ms_by_kernel": parts,
            "library_device_ms": device(torch, library),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "work": {"flops_per_pair": {"bound": FA_BWD_WORK["bound"] * d,
                                        "kernels": FA_BWD_WORK[dtype] * d},
                     "ms": work_ms}}


def phase_kernel_bwd(torch):
    """Flash backward: its instantiations' build and SASS report; kernels
    vs plain on the card (same q/k/v/o/lse/dO into both), then timings at
    the training shape in the training layout. The train phase's case
    heads the kernels line's row: its errors go with its timing."""
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa

    instantiations = flash_bwd_report(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    results, worst, main_err = [], {}, None
    for case in flash_cases():
        b, h, hkv, tq, tk, d, causal, dtype, layout = case
        q, k, v = _qkv(torch, b, h, hkv, tq, tk, d, dtype, gen, layout)
        o, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                          return_lse=True)
        # dO in q's layout, as autograd hands it back through the views
        do = _randn(torch, b, h, tq, d, dtype, gen, layout)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        errs, typical = {}, {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            atol, rtol = BWD_TOL[dtype][name]
            torch.testing.assert_close(g.float(), w.float(), atol=atol,
                                       rtol=rtol, msg=lambda m, n=name: (
                                           "%s: %s" % (n, m)))
            errs[name] = float((g.float() - w.float()).abs().max())
            typical[name] = float(w.float().abs().median())
        results.append({"shape": [b, h, hkv, tq, tk, d], "causal": causal,
                        "dtype": dtype, "layout": LAYOUTS[layout],
                        "tol": BWD_TOL[dtype], "max_abs_err": errs,
                        "median_abs": typical})
        worst[dtype] = max([worst.get(dtype, 0.0)] + list(errs.values()))
        if case == train_main_case():
            main_err = errs
        del q, k, v, o, lse, do, got, want
        torch.cuda.empty_cache()

    timings = {}
    h, hkv, t, d = 16, 4, 2048, 128
    # batch 4 in both types (the rows of earlier PRs), and the train
    # phase's own batch in its type under "train_main"
    for key, b, dtype in ((("float32", 4, "float32"), ("bfloat16", 4,
                                                       "bfloat16"),
                           ("train_main", TRAIN["batch"], TRAIN["dtype"]))):
        q, k, v = _qkv(torch, b, h, hkv, t, t, d, dtype, gen, False)
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        do = _randn(torch, b, h, t, d, dtype, gen, False)
        timings[key] = bwd_timing(
            torch, (b, h, hkv, t, d, True), dtype,
            lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, True),
            lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True),
            _sdpa_bwd(torch, q, k, v, do))
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()
    timings["train_main"]["main_path_max_abs_err"] = main_err
    emit({"phase": "kernel", "kernel": "flash_attention_bwd",
          "instantiations": instantiations, "cases": results,
          "max_abs_err": worst, "timings": timings})
    return worst, timings


def phase_kernel_update(torch):
    """Fused updates: kernel vs plain on the card (clip and rescale on and
    off, the LM's two largest shapes, a ragged length, f32 and bf16), then
    one timed pass over all of the LM's parameters (f32)."""
    from mxnet_tpu_torch.ops.kernels import fused_update as fu

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    hyper = {"sgd_mom_update": dict(lr=0.05, momentum=0.9, wd=1e-4),
             "adam_update": dict(lr=1e-3, beta1=0.9, beta2=0.999,
                                 epsilon=1e-8, wd=1e-4)}
    plain = {"sgd_mom_update": fu.sgd_mom_update_plain,
             "adam_update": fu.adam_update_plain}
    kernel = {"sgd_mom_update": fu.sgd_mom_update,
              "adam_update": fu.adam_update}
    n_state = {"sgd_mom_update": 1, "adam_update": 2}

    def buffers(kind, shape, dtype):
        dt = getattr(torch, dtype)
        w, g = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                for _ in range(2))
        states = [torch.randn(shape, generator=gen, device="cuda").to(dt)
                  for _ in range(n_state[kind])]
        if kind == "adam_update":
            # a running mean of g * g, kept off zero so lr * m / sqrt(v)
            # stays at the scale of real steps
            states[1] = states[1].abs() + 0.01
        return [w, g] + states

    cases = []
    for shape, dtype in (((8192, 2048), "float32"), ((10000, 2048),
                                                     "float32"),
                         ((1001,), "float32"), ((8192, 2048), "bfloat16"),
                         ((1001,), "bfloat16")):
        for rescale, clip in ((1.0, -1.0), (0.5, 0.3)):
            cases.append((shape, dtype, rescale, clip))
    lr_kernel = {"sgd_mom_update": fu.sgd_mom_update_lr,
                 "adam_update": fu.adam_update_lr}
    lr_plain = {"sgd_mom_update": fu.sgd_mom_update_lr_plain,
                "adam_update": fu.adam_update_lr_plain}

    def lr_args(kind, index=2):
        """The device-lr entry's form of ``hyper[kind]``: lr and wd at
        ``index`` of two f32 arrays on the card, the rest as before."""
        h = dict(hyper[kind])
        lr_arr = torch.tensor([0.5, 0.25, h.pop("lr"), 0.125],
                              device="cuda")
        wd_arr = torch.tensor([1.0, 0.5, h.pop("wd"), 0.0], device="cuda")
        return (lr_arr, wd_arr, index), h

    results, worst = [], {k: 0.0 for k in kernel}
    device_lr = []
    for kind in kernel:
        for shape, dtype, rescale, clip in cases:
            bufs = buffers(kind, shape, dtype)
            got = [t.clone() for t in bufs]
            want = [t.clone() for t in bufs]
            kernel[kind](*got, rescale_grad=rescale, clip_gradient=clip,
                         **hyper[kind])
            plain[kind](*want, rescale_grad=rescale, clip_gradient=clip,
                        **hyper[kind])
            # the device-lr entry point: bit for bit the scalar kernel's,
            # and its plain version bit for bit the scalar plain one's
            lr, rest = lr_args(kind)
            got_lr = [t.clone() for t in bufs]
            want_lr = [t.clone() for t in bufs]
            lr_kernel[kind](*got_lr, *lr, rescale_grad=rescale,
                            clip_gradient=clip, **rest)
            lr_plain[kind](*want_lr, *lr, rescale_grad=rescale,
                           clip_gradient=clip, **rest)
            torch.cuda.synchronize()
            same = (all(torch.equal(a, b) for a, b in zip(got_lr, got)),
                    all(torch.equal(a, b) for a, b in zip(want_lr, want)))
            if not all(same):
                raise RuntimeError(
                    "%s device-lr entry at %s %s: kernel equals the scalar "
                    "one %s, plain equals the scalar plain %s"
                    % (kind, shape, dtype, same[0], same[1]))
            device_lr.append({"kernel": kind + "_lr", "shape": list(shape),
                              "dtype": dtype, "rescale_grad": rescale,
                              "clip_gradient": clip,
                              "equals_scalar_kernel": True,
                              "plain_equals_scalar_plain": True})
            atol, rtol = UPDATE_TOL[dtype]
            errs = []
            for i, (g, w) in enumerate(zip(got, want)):
                if i == 1:
                    continue  # the gradient is an input only
                torch.testing.assert_close(g.float(), w.float(), atol=atol,
                                           rtol=rtol)
                errs.append(float((g.float() - w.float()).abs().max()))
            results.append({"kernel": kind, "shape": list(shape),
                            "dtype": dtype, "rescale_grad": rescale,
                            "clip_gradient": clip, "atol": atol,
                            "rtol": rtol, "max_abs_err": errs})
            worst[kind] = max([worst[kind]] + errs)

    shapes = list(lm_param_shapes(LM).values())
    elements = int(sum(np.prod(s) for s in shapes))
    timings = {}
    for kind in kernel:
        params = [buffers(kind, s, "float32") for s in shapes]
        for p in params:
            if kind == "adam_update":
                p[3].zero_()
        bound_ms, bound_by = update_bound(kind, elements)
        lr, rest = lr_args(kind)
        timings[kind] = {
            "parameters": len(shapes), "elements": elements,
            "dtype": "float32",
            "ms": time_ms(torch, lambda: [kernel[kind](*p, **hyper[kind])
                                          for p in params], reps=10),
            "device_lr_ms": time_ms(torch, lambda: [lr_kernel[kind](
                *p, *lr, **rest) for p in params], reps=10),
            "plain_ms": time_ms(torch, lambda: [plain[kind](
                *p, **hyper[kind]) for p in params], reps=10),
            "library_ms": None,
            "library_note": "no single PyTorch call has MXNet's update "
                            "convention (torch.optim's momentum and Adam "
                            "differ)",
            "bound_ms": bound_ms, "bound_by": bound_by}
        del params
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "kernel": "fused_update", "cases": results,
          "device_lr_cases": device_lr, "max_abs_err": worst,
          "timings": timings})
    return worst, timings


def wgrad_cases():
    """Cases (n, h, c, k, ksz, stride, dtype) of conv_wgrad: ResNet-50's
    seven 3x3 shapes at batch 32, and tests/test_consistency.py:370-374's
    odd cases (odd size, stride 2, 1x1, C 4 to 16), in f32 and bf16."""
    odd = [(2, 8, 8, 16, 3, 1), (2, 9, 8, 16, 3, 1), (2, 8, 8, 16, 3, 2),
           (1, 5, 4, 8, 1, 1), (4, 7, 16, 32, 3, 1)]
    return [case + (dtype,) for dtype in ("float32", "bfloat16")
            for case in [(32, h, c, c, 3, s) for h, c, s in RESNET_WGRAD]
            + odd]


def wgrad_report(torch):
    """conv_wgrad's instantiations (:func:`instantiation_report`): the
    wgmma and the two f32 partial kernels at bn = 64 and 128 (the simt,
    repack and reduce kernels are not templated)."""
    import ctypes

    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import conv_wgrad as cw

    smem = _build.kernel(cw._NAME, "mxtt_conv_wgrad_smem",
                         [ctypes.c_int, ctypes.c_int])
    sass = sass_counts(_build.lib_path(cw._NAME), tuple(WGRAD_KERNELS),
                       FA_BF16_OPCODES)
    return instantiation_report(
        _build.log_of(cw._NAME), sass, WGRAD_KERNELS, cw.BLOCK_COLS,
        lambda name, dtype, bn: smem(0 if dtype == "float32" else 1, bn))


def wgrad_route_check(plans, report):
    """Fails unless every ResNet-50 bf16 shape (``plans``: [(case, Plan)])
    takes the wgmma route into an instantiation whose SASS holds HGMMA and
    UTMALDG (``report`` of :func:`wgrad_report`), and every f32 one the
    f32 route; returns {case: route}."""
    routes = {}
    for case, p in plans:
        dtype = case[-1]
        want = "wgmma" if dtype == "bfloat16" else "f32"
        if p.route != want:
            raise RuntimeError("conv_wgrad %s takes the %s route, want %s"
                               % (case, p.route, want))
        label = "%s<%d>" % (p.kernel, p.bn)
        row = report.get(label)
        if row is None:
            raise RuntimeError("conv_wgrad %s: no report for %s"
                               % (case, label))
        if want == "wgmma" and not all(
                row["sass"].get(op, 0) > 0 for op in FA_BF16_OPCODES):
            raise RuntimeError("conv_wgrad %s runs %s, which lacks %s: %s"
                               % (case, label, FA_BF16_OPCODES, row["sass"]))
        routes[case] = label
    return routes


def wgrad_timing(torch, case, p, fn, plain, library,
                 timers=(time_ms, device_ms, device_ms_by)):
    """One timing row of conv_wgrad at ``case`` (n, h, c, k, ksz, stride,
    dtype) with plan ``p``: single calls of the wrapper (``fn``: the
    repack, partial and reduce kernels), of the plain version and of the
    library yardstick (CUDA events, the host's enqueue included), and the
    device times of the call (split into the partial kernel, the reduce
    kernel, the wgmma route's two repacks of the NCHW views, and the rest)
    and of the library's, beside the bound."""
    single, device, device_by = timers
    n, h, c, k, ksz, stride, dtype = case
    bound_ms, bound_by = wgrad_bound(n, h, c, k, ksz, stride, dtype)
    repacks = 2 if p.route == "wgmma" else 0
    dev, parts = device_by(
        torch, fn, {"partial": p.kernel, "reduce": "conv_wgrad_reduce",
                    "repack": "conv_wgrad_repack"},
        calls={p.kernel: 1, "conv_wgrad_reduce": 1,
               "conv_wgrad_repack": repacks})
    parts["other"] = dev - parts["partial"] - parts["reduce"] - \
        parts["repack"]
    return {"shape": [n, h, c, k, ksz, stride],
            "per_step": RESNET_WGRAD[(h, c, stride)],
            "route": p.route, "kernel": p.kernel, "bn": p.bn, "box": p.box,
            "splits": p.splits,
            "ms": single(torch, fn), "device_ms": dev,
            "device_ms_by_kernel": parts,
            "plain_ms": single(torch, plain),
            "library_ms": single(torch, library),
            "library_device_ms": device(torch, library),
            "bound_ms": bound_ms, "bound_by": bound_by}


# the keys of a wgrad_timing row that a step sums
WGRAD_STEP_KEYS = ("ms", "device_ms", "plain_ms", "library_ms",
                   "library_device_ms", "bound_ms")


def wgrad_step(rows):
    """Each of ``WGRAD_STEP_KEYS`` summed over a ResNet-50 step: each
    shape's row times its ``per_step``; the device split likewise."""
    step = {key: sum(t[key] * t["per_step"] for t in rows)
            for key in WGRAD_STEP_KEYS}
    step["device_ms_by_kernel"] = {
        part: sum(t["device_ms_by_kernel"][part] * t["per_step"]
                  for t in rows)
        for part in ("partial", "reduce", "repack", "other")}
    return step


def phase_kernel_wgrad(torch):
    """conv_wgrad: its instantiations' build and SASS report; kernel vs
    plain on the card, on the NCHW tensors' NHWC views the Convolution op
    passes (f32 through ``wgrad``, bf16 through the reference's
    ``conv_wgrad``), each case's route named; the ResNet-50 shapes must
    take the wgmma (bf16) and f32 routes; then each ResNet-50 shape timed
    beside the plain version and cuDNN's wgrad, with device times."""
    from mxnet_tpu_torch.ops.kernels import conv_wgrad as cw

    instantiations = wgrad_report(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    results, worst, timings = [], {}, {"float32": [], "bfloat16": []}
    resnet_plans = []
    for case in wgrad_cases():
        n, h, c, k, ksz, stride, dtype = case
        pad = (ksz - 1) // 2
        oh = cw.out_size(h, ksz, stride, pad)
        dt = getattr(torch, dtype)
        x = torch.randn(n, c, h, h, generator=gen, device="cuda").to(dt)
        dy = torch.randn(n, k, oh, oh, generator=gen, device="cuda").to(dt)
        xv, dv = x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1)
        p = cw.plan_of(xv, dv, ksz, stride, pad)
        fn = cw.wgrad if dtype == "float32" else cw.conv_wgrad
        got = fn(xv, dv, ksz, stride, pad)
        again = fn(xv, dv, ksz, stride, pad)
        want = cw.conv_wgrad_plain(xv, dv, ksz, stride, pad)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        if not rel <= WGRAD_RTOL:
            raise RuntimeError("conv_wgrad %s (%s route): error %g of max "
                               "|dW| (tol %g)" % (case, p.route, rel,
                                                  WGRAD_RTOL))
        if not torch.equal(got, again):
            raise RuntimeError("conv_wgrad %s (%s route): two calls differ"
                               % (case, p.route))
        results.append({"shape": [n, h, c, k, ksz, stride], "dtype": dtype,
                        "layout": "nchw view", "route": p.route,
                        "kernel": p.kernel, "bn": p.bn, "box": p.box,
                        "splits": p.splits,
                        "max_abs_err": err, "err_of_max": rel})
        worst[dtype] = max(worst.get(dtype, 0.0), err)
        if (h, c, stride) in RESNET_WGRAD and n == 32:
            resnet_plans.append((case, p))
            timings[dtype].append(wgrad_timing(
                torch, case, p, lambda: fn(xv, dv, ksz, stride, pad),
                lambda: cw.conv_wgrad_plain(xv, dv, ksz, stride, pad),
                lambda: torch.nn.grad.conv2d_weight(
                    x, (k, c, ksz, ksz), dy, stride=stride, padding=pad)))
        del x, dy, xv, dv, got, again, want
    routes = wgrad_route_check(resnet_plans, instantiations)
    step = {dtype: wgrad_step(ts) for dtype, ts in timings.items()}
    emit({"phase": "kernel", "kernel": "conv_wgrad",
          "instantiations": instantiations,
          "resnet_instantiations": {"%s/%s" % (c[-1], c[:-1]): label
                                    for c, label in routes.items()},
          "cases": results, "tol_of_max": WGRAD_RTOL, "max_abs_err": worst,
          "timings": timings, "per_step": step})
    return worst, timings, step


# the layouts of _lstm_inputs, by name
LSTM_LAYOUTS = {
    "views": "blob view at an odd offset, broadcast state",
    "contiguous": "blob view at an odd offset, contiguous state",
    "scan": "blob view at the LM's offset 4H*I, contiguous state"}


def _lstm_inputs(torch, n, h, dtype, gen, layout="views"):
    """Seeded lstm_step inputs as the fused RNN op hands them over: ``wh``
    a (4H, H) view into a parameter blob, at an odd element offset (in
    bf16 not 16-byte aligned) or, in the ``"scan"`` layout, at the LM's
    first layer's 4H * I (I = H); ``h`` / ``c`` broadcast views (stride 0
    along the hidden and the batch axis) in the ``"views"`` layout, their
    contiguous copies in ``"contiguous"``, and full (N, H) rows in
    ``"scan"`` (ys[t - 1] and the c buffer of the scan)."""
    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    ib = randn(n, 4 * h).to(dt)
    off = 4 * h * h if layout == "scan" else 3
    blob = (randn(off + 4 * h * h + 5) / math.sqrt(h)).to(dt)
    wh = blob[off:off + 4 * h * h].view(4 * h, h)
    if layout == "scan":
        return ib, (0.5 * randn(n, h)).to(dt), randn(n, h).to(dt), wh
    hs = (0.5 * randn(n, 1)).to(dt).expand(n, h)
    cs = randn(1, h).to(dt).expand(n, h)
    if layout == "contiguous":
        hs, cs = hs.contiguous(), cs.contiguous()
    return ib, hs, cs, wh


def _fused_lstm_cell(torch, ib, h, c, wh):
    """The step's library yardstick: cuBLAS's h . Wh^T, then PyTorch's
    fused LSTM pointwise kernel (CUDA only). No single PyTorch call
    computes the step. Timed only; the port never calls it."""
    cell = torch.ops.aten._thnn_fused_lstm_cell
    return lambda: cell(ib, torch.mm(h, wh.t()), c)


def lstm_label(p):
    """The instantiation label (:func:`kernel_label`) of lstm_step plan
    ``p``."""
    tile = p.tile if isinstance(p.tile, tuple) else (p.tile,)
    return "%s<%s>" % (p.kernel, ",".join(str(t) for t in tile))


def lstm_instantiations(log, sass, smem_of):
    """lstm_step's instantiations: the f32 and wgmma bodies through
    :func:`instantiation_report` (which fails on f32 spills and on a wgmma
    body without HGMMA or UTMALDG), and the simt body's registers and
    spills from the ptxas ``log``."""
    report = {}
    for name, (dtype, tiles) in LSTM_KERNELS.items():
        report.update(instantiation_report(log, sass, {name: dtype}, tiles,
                                           smem_of))
    for label, row in ptxas_report(log, (LSTM_SIMT,)).items():
        report[label] = dict(row, dtype="bfloat16",
                             sass=sass.get(label, {}))
    return report


def lstm_report(torch):
    """:func:`lstm_instantiations` of the built library's log and SASS."""
    import ctypes

    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import lstm as kl

    smem = _build.kernel(kl._NAME, "mxtt_lstm_step_smem", [ctypes.c_int] * 2)
    sass = sass_counts(_build.lib_path(kl._NAME),
                       tuple(LSTM_KERNELS) + (LSTM_SIMT,), FA_BF16_OPCODES)
    return lstm_instantiations(
        _build.log_of(kl._NAME), sass, lambda name, dtype, tile: smem(
            kl.ROUTE_CODE["f32" if dtype == "float32" else "wgmma"], tile))


def lstm_route_check(plans, report, main=LSTM_MAIN):
    """Fails unless each main-path shape (``main``) in the scan's layout
    (``plans``: [((n, h), dtype, layout, Plan)]) takes the f32 tile body
    with 16-byte copies of h and Wh (f32) or the wgmma body (bf16), into an
    instantiation of ``report`` (:func:`lstm_report`) whose SASS holds
    HGMMA and UTMALDG and whose build has no C7515 / C7520 note (bf16);
    returns {"dtype/[n, h]/layout": label} of every plan."""
    routes = {}
    for (n, h), dtype, layout, p in plans:
        label = lstm_label(p)
        routes["%s/%s/%s" % (dtype, [n, h], layout)] = label
        if (n, h) not in main or layout != "scan":
            continue
        what = "lstm_step %s %s in the scan's layout" % (dtype, (n, h))
        want = "f32" if dtype == "float32" else "wgmma"
        if p.route != want:
            raise RuntimeError("%s takes the %s route, want %s"
                               % (what, p.route, want))
        if want == "f32" and not (p.vec_h and p.vec_w):
            raise RuntimeError("%s copies h / Wh 4 bytes a time (vec %s, "
                               "%s)" % (what, p.vec_h, p.vec_w))
        row = report.get(label)
        if row is None:
            raise RuntimeError("%s: no report for %s" % (what, label))
        if want == "wgmma":
            if not all(row["sass"].get(op, 0) > 0 for op in FA_BF16_OPCODES):
                raise RuntimeError("%s runs %s, which lacks %s: %s"
                                   % (what, label, FA_BF16_OPCODES,
                                      row["sass"]))
            if row["wgmma_serialized"]:
                raise RuntimeError("%s runs %s, whose wgmma ptxas "
                                   "serializes (C7515 / C7520)"
                                   % (what, label))
    return routes


def lstm_timing(torch, n, h, dtype, p, fns,
                timers=(graph_ms, device_ms, time_ms)):
    """One timing row of lstm_step at (n, h) in ``dtype`` with plan ``p``:
    each (name, fn) of ``fns`` (the kernel's "ms", the plain version's and
    the library yardstick's) timed over graph replays of 35 calls, by the
    profiler's device time and by single-call CUDA events, beside the
    bound."""
    replay, device, single = timers
    bound_ms, bound_by = lstm_step_bound(n, h, dtype)
    return dict({k: replay(torch, f) for k, f in fns},
                shape=[n, h], layout=LSTM_LAYOUTS["scan"], route=p.route,
                kernel=lstm_label(p),
                device_ms={k: device(torch, f, reps=20) for k, f in fns},
                event_ms={k: single(torch, f, reps=20) for k, f in fns},
                bound_ms=bound_ms, bound_by=bound_by)


def phase_kernel_lstm(torch):
    """lstm_step: its instantiations' build and SASS report; kernel vs
    plain on the card at LSTM_CASES, f32 and bf16, in each of LSTM_LAYOUTS,
    each case's route named; the scan's main-path shapes must take the f32
    tile body and the wgmma body; the 35-step fused scan vs the plain scan;
    then the step timed at (128, 512) in the scan's layout beside the plain
    version and cuBLAS + the fused LSTM cell in both types, and one whole
    layer (input projection + 35 steps) beside cuDNN's LSTM. A step's
    ``ms``, ``plain_ms`` and ``library_ms`` are CUDA-event medians over
    graph replays of 35 calls (:func:`graph_ms`), with the profiler's
    device times under ``device_ms``; the layer's are the profiler's
    device times. Single-call CUDA-event times, the host's enqueue
    included, are under ``event_ms``."""
    from mxnet_tpu_torch.ops import rnn_fused as rf
    from mxnet_tpu_torch.ops.kernels import lstm as kl

    instantiations = lstm_report(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    results, worst, plans = [], {}, []
    for dtype in ("float32", "bfloat16"):
        atol, rtol = LSTM_TOL[dtype]
        for n, h in LSTM_CASES:
            for layout in LSTM_LAYOUTS:
                ib, hs, cs, wh = _lstm_inputs(torch, n, h, dtype, gen,
                                              layout)
                p = kl.plan_of(hs, wh)
                got = kl.lstm_step(ib, hs, cs, wh)
                want = kl.lstm_step_plain(ib, hs, cs, wh)
                torch.cuda.synchronize()
                errs = []
                for name, g, w in zip(("h", "c"), got, want):
                    torch.testing.assert_close(
                        g.float(), w.float(), atol=atol, rtol=rtol,
                        msg=lambda m, k=name: "lstm_step %s %s: %s" % (
                            (n, h, dtype, layout, p.route), k, m))
                    errs.append(float((g.float() - w.float()).abs().max()))
                results.append({"shape": [n, h], "dtype": dtype,
                                "layout": LSTM_LAYOUTS[layout],
                                "route": p.route, "kernel": lstm_label(p),
                                "vec": [p.vec_h, p.vec_w],
                                "atol": atol, "rtol": rtol,
                                "max_abs_err": {"h": errs[0],
                                                "c": errs[1]}})
                plans.append(((n, h), dtype, layout, p))
                worst[dtype] = max([worst.get(dtype, 0.0)] + errs)
    routes = lstm_route_check(plans, instantiations,
                              main=LSTM_MAIN + (BUCKET_STEP,))

    # the 35-step scan at the LM's shape: kernel scan vs plain scan, f32
    cfg = LSTM_LM
    t, n, h = cfg["seq"], cfg["batch"], cfg["hidden"]
    _, h0, c0, wh = _lstm_inputs(torch, n, h, "float32", gen)
    ib = torch.randn(t, n, 4 * h, generator=gen, device="cuda")
    with torch.no_grad():
        got = rf.LSTMScan.apply(ib, h0, c0, wh)
        want = rf._lstm_scan_plain(ib, h0, c0, wh, h)
    torch.cuda.synchronize()
    scan_err = {}
    for name, g, w in zip(("ys", "h", "c"), got, want):
        torch.testing.assert_close(g, w, atol=LSTM_SCAN_TOL[0],
                                   rtol=LSTM_SCAN_TOL[1])
        scan_err[name] = float((g - w).abs().max())
    del ib, got, want

    timings = {}
    # the LM's (128, 512) in both types; the bucketing run's (32, 512), f32
    for key, (tn, dtype) in (("float32", (n, "float32")),
                             ("bfloat16", (n, "bfloat16")),
                             ("bucketing_float32", (BUCKET_STEP[0],
                                                    "float32"))):
        ib, hs, cs, wh = _lstm_inputs(torch, tn, h, dtype, gen, "scan")
        h_out, c_out = torch.empty_like(hs), torch.empty_like(cs)
        timings[key] = lstm_timing(
            torch, tn, h, dtype, kl.plan_of(hs, wh),
            (("ms", lambda: kl.lstm_step(ib, hs, cs, wh, h_out, c_out)),
             ("plain_ms", lambda: kl.lstm_step_plain(ib, hs, cs, wh)),
             ("library_ms", _fused_lstm_cell(torch, ib, hs, cs, wh))))

    # one whole layer at the LM's shape, f32: the port's scan (input
    # projection + 35 kernel steps) vs the plain scan vs cuDNN's LSTM with
    # the same weights (gate order i, f, g, o in both)
    i = cfg["embed"]
    x = torch.randn(t, n, i, generator=gen, device="cuda")
    wi = torch.randn(4 * h, i, generator=gen, device="cuda") / math.sqrt(i)
    wh = torch.randn(4 * h, h, generator=gen, device="cuda") / math.sqrt(h)
    bi, bh = (0.1 * torch.randn(4 * h, generator=gen, device="cuda")
              for _ in range(2))
    h0, c0 = (torch.zeros(n, h, device="cuda") for _ in range(2))
    cudnn = torch.nn.LSTM(i, h).cuda()
    with torch.no_grad():
        for name, w in (("weight_ih_l0", wi), ("weight_hh_l0", wh),
                        ("bias_ih_l0", bi), ("bias_hh_l0", bh)):
            getattr(cudnn, name).copy_(w)
        port = lambda: rf._lstm_scan(x, h0, c0, wi, wh, bi, bh)
        plain = lambda: rf._lstm_scan_plain(
            torch.matmul(x, wi.t()) + (bi + bh), h0, c0, wh, h)
        library = lambda: cudnn(x, (h0[None], c0[None]))
        ys = port()[0]
        ys_lib = library()[0]
        torch.cuda.synchronize()
        torch.testing.assert_close(ys, ys_lib, atol=LSTM_SCAN_TOL[0],
                                   rtol=LSTM_SCAN_TOL[1])
        bound_ms, bound_by = lstm_layer_bound(t, n, i, h)
        dev, event = _times(torch, (("ms", port), ("plain_ms", plain),
                                    ("library_ms", library)), reps=10)
        layer = dict(dev, shape=[t, n, i, h], dtype="float32",
                     max_abs_err_vs_cudnn=float((ys - ys_lib).abs().max()),
                     event_ms=event,
                     library="torch.nn.LSTM (cuDNN, no TF32)",
                     bound_ms=bound_ms, bound_by=bound_by)
    emit({"phase": "kernel", "kernel": "lstm_step",
          "instantiations": instantiations, "routes": routes,
          "cases": results,
          "max_abs_err": worst, "scan_max_abs_err": scan_err,
          "scan_tol": LSTM_SCAN_TOL, "timings": timings, "layer": layer})
    return worst, timings, layer


def rtc_bwd_route_check(rows, cols, bp):
    """``bp`` (rtc_softmax's BwdPlan at (rows, cols)) if it takes the
    route RTC_BWD_ROUTES names for that shape, else a failure."""
    want = RTC_BWD_ROUTES.get((rows, cols), bp.route)
    if bp.route != want:
        raise RuntimeError("rtc_softmax bwd %s takes the %s route, want %s"
                           % ((rows, cols), bp.route, want))
    return bp


def rtc_timing(torch, rows, cols, pairs, timers=(loop_ms, device_ms)):
    """One timing row of an rtc_softmax kernel at (rows, cols): each
    (name, fn) of ``pairs`` timed over runs of back-to-back calls (CUDA
    events, median) and by the profiler's device time, beside the
    bound."""
    loop, device = timers
    bound_ms, bound_by = rtc_softmax_bound(rows, cols)
    return dict({k: loop(torch, f) for k, f in pairs},
                device_ms={k: device(torch, f, reps=10) for k, f in pairs},
                shape=[rows, cols], bound_ms=bound_ms, bound_by=bound_by)


def phase_kernel_rtc(torch):
    """mx.rtc on the card: the JAX tests' kernels (axpy, inc, relu; axpy in
    bf16) as CUDA C, each against its mode="torch" twin; the source cache
    (a second create is the same object, a second push compiles nothing);
    a syntax error raising NVRTC's log and a refused launch raising; then
    the rtc_softmax kernels against their twins at RTC_SOFTMAX_CASES, and
    at (4480, 10000) timed (CUDA events over back-to-back calls, median, and
    the profiler's device time) beside the twins and torch.softmax."""
    from mxnet_tpu_torch import nd, rtc
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops.kernels import rtc_driver
    from mxnet_tpu_torch.tools import rtc_softmax as rs

    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    tests, compile_ms = [], {}
    for name, (ins, body, twin_src, dtype) in RTC_ELEMENTWISE.items():
        dt = getattr(torch, dtype)
        for shape in RTC_ELEMENTWISE_SHAPES:
            n = int(np.prod(shape))
            src = rtc_elementwise_src(body, n)
            kern = rtc.create(name, list(ins), ["out"], src)
            twin = rtc.create(name, list(ins), ["out"], twin_src,
                              mode="torch")
            xs = [nd.NDArray(randn(*shape, dtype=dt)) for _ in ins]
            got = nd.NDArray(torch.zeros(shape, dtype=dt, device="cuda"))
            want = nd.NDArray(torch.zeros(shape, dtype=dt, device="cuda"))
            block = 256
            kern.push(xs, [got], grid_dims=(-(-n // block),),
                      block_dims=(block,))
            twin.push(xs, [want])
            torch.cuda.synchronize()
            torch.testing.assert_close(
                got._data.float(), want._data.float(), rtol=RTC_TOL[dtype],
                atol=0.0, msg=lambda m, k=(name, shape): "rtc %s %s: %s"
                % (k[0], k[1], m))
            tests.append({"kernel": name, "shape": list(shape),
                          "dtype": dtype, "rtol": RTC_TOL[dtype],
                          "max_abs_err": float((got._data.float()
                                                - want._data.float())
                                               .abs().max())})
            compile_ms["%s %s" % (name, list(shape))] = list(
                kern.compile_ms.values())

    # the cache: the same source is the same object, compiled once
    name, (ins, body, _, _) = "inc", RTC_ELEMENTWISE["inc"]
    src = rtc_elementwise_src(body, 128)
    first = rtc.create(name, list(ins), ["out"], src)
    before = rtc_driver.compiles
    again = rtc.create(name, list(ins), ["out"], src)
    x = nd.NDArray(randn(8, 16))
    out = nd.NDArray(torch.zeros(8, 16, device="cuda"))
    again.push([x], [out], grid_dims=(1,), block_dims=(128,))
    torch.cuda.synchronize()
    if again is not first or rtc_driver.compiles != before \
            or len(first.compile_ms) != 1:
        raise RuntimeError("rtc cache: a second create or push compiled "
                           "again (%d compiles before, %d after)"
                           % (before, rtc_driver.compiles))

    # a syntax error raises NVRTC's log; a launch the card refuses raises
    bad = rtc.create("bad_syntax", ["x"], ["out"], "out[0] = x[0] +;")
    try:
        bad.push([x], [out], grid_dims=(1,), block_dims=(1,))
    except MXNetError as e:
        syntax_error = str(e).splitlines()
    else:
        raise RuntimeError("rtc: a syntax error compiled")
    if not any("bad_syntax.cu(" in ln and "error" in ln
               for ln in syntax_error):
        raise RuntimeError("rtc: the compile error lacks NVRTC's log: %s"
                           % syntax_error)
    try:
        first.push([x], [out], grid_dims=(1,), block_dims=(2048,))
    except MXNetError as e:
        refused = str(e)
    else:
        raise RuntimeError("rtc: a launch of 2048 threads a block ran")
    torch.cuda.synchronize()

    # rtc_softmax: kernels vs twins at each case
    cases, worst = [], 0.0
    for rows, cols in RTC_SOFTMAX_CASES:
        kern, twin = rs.kernels(cols), rs.twins()
        x = nd.NDArray(3.0 * randn(rows, cols))
        label = nd.NDArray(torch.randint(0, cols, (rows,), generator=gen,
                                         device="cuda").float())
        prob, prob_t, grad, grad_t = (
            nd.NDArray(torch.zeros(rows, cols, device="cuda"))
            for _ in range(4))
        block, per = rs.launch_dims(cols)
        kern["fwd"].push([x], [prob], grid_dims=(rows,), block_dims=(block,))
        twin["fwd"].push([x], [prob_t])
        bp = rtc_bwd_route_check(rows, cols, rs.bwd_plan(
            cols, prob._data.data_ptr(), grad._data.data_ptr()))
        rs.push("bwd", [prob, label], [grad])
        twin["bwd"].push([prob, label], [grad_t])
        # the scalar source as well where the vector one ran
        pairs = [("fwd", prob, prob_t), ("bwd", grad, grad_t)]
        if bp.route == "vector":
            scalar = nd.NDArray(torch.zeros(rows, cols, device="cuda"))
            kern["bwd"].push([prob, label], [scalar], grid_dims=(rows,),
                             block_dims=(block,))
            pairs.append(("bwd_scalar", scalar, grad_t))
        torch.cuda.synchronize()
        errs, rel_errs = {}, {}
        for what, g, w in pairs:
            for atol, rtol in ((RTC_SOFTMAX_ATOL, 0.0),
                               (RTC_SOFTMAX_FLOOR, RTC_SOFTMAX_RTOL)):
                torch.testing.assert_close(
                    g._data, w._data, atol=atol, rtol=rtol,
                    msg=lambda m, k=(what, rows, cols): "rtc_softmax %s %s: "
                    "%s" % (k[0], k[1:], m))
            diff = (g._data - w._data).abs()
            errs[what] = float(diff.max())
            rel_errs[what] = float((diff / (w._data.abs()
                                            + RTC_SOFTMAX_FLOOR)).max())
        row_sum = float((prob._data.double().sum(1) - 1.0).abs().max())
        if not row_sum <= RTC_SOFTMAX_ROW_SUM:
            raise RuntimeError("rtc_softmax %s: a row of probabilities sums "
                               "to 1 within %g, not %g"
                               % ((rows, cols), row_sum, RTC_SOFTMAX_ROW_SUM))
        cases.append({"shape": [rows, cols], "block": block,
                      "per_thread": per, "bwd_route": bp.route,
                      "bwd_block": bp.block, "bwd_per_thread": bp.per,
                      "max_abs_err": errs,
                      "max_rel_err": rel_errs, "max_row_sum_err": row_sum,
                      "compile_ms": {k: list(v.compile_ms.values())
                                     for k, v in kern.items()}})
        worst = max([worst] + list(errs.values()))

    # timing at the LM's shape
    rows, cols = RTC_SOFTMAX_CASES[0]
    kern, twin = rs.kernels(cols), rs.twins()
    block, _ = rs.launch_dims(cols)
    x = nd.NDArray(3.0 * randn(rows, cols))
    label = nd.NDArray(torch.randint(0, cols, (rows,), generator=gen,
                                     device="cuda").float())
    prob, out = (nd.NDArray(torch.zeros(rows, cols, device="cuda"))
                 for _ in range(2))
    kern["fwd"].push([x], [prob], grid_dims=(rows,), block_dims=(block,))
    # the backward's library yardstick: one out-of-place scatter_add of -1
    # at each row's label is p - onehot(label); held against the kernel
    idx = label._data.long()[:, None]
    minus_one = torch.full((rows, 1), -1.0, device="cuda")
    bp = rtc_bwd_route_check(rows, cols, rs.bwd_plan(
        cols, prob._data.data_ptr(), out._data.data_ptr()))
    rs.push("bwd", [prob, label], [out])
    torch.testing.assert_close(torch.scatter_add(prob._data, 1, idx,
                                                 minus_one),
                               out._data, atol=0.0, rtol=0.0)
    fns = {"fwd": (("ms", lambda: kern["fwd"].push(
                        [x], [out], grid_dims=(rows,), block_dims=(block,))),
                   ("plain_ms", lambda: twin["fwd"].push([x], [out])),
                   ("library_ms", lambda: torch.softmax(x._data, dim=1))),
           "bwd": (("ms", lambda: rs.push("bwd", [prob, label], [out])),
                   ("scalar_ms", lambda: kern["bwd"].push(
                       [prob, label], [out], grid_dims=(rows,),
                       block_dims=(block,))),
                   ("plain_ms", lambda: twin["bwd"].push([prob, label],
                                                          [out])),
                   ("library_ms", lambda: torch.scatter_add(
                       prob._data, 1, idx, minus_one)))}
    timings = {kind: rtc_timing(torch, rows, cols, pairs)
               for kind, pairs in fns.items()}
    timings["fwd"].update(block=block, library="torch.softmax(x, dim=1)",
                          compile_ms=list(kern["fwd"].compile_ms.values()))
    timings["bwd"].update(
        bwd_route=bp.route, block=bp.block, per_thread=bp.per,
        scalar_block=block,
        compile_ms={k: list(kern[k].compile_ms.values())
                    for k in ("bwd", "bwd_vec")})
    timings["bwd"]["library"] = ("torch.scatter_add(p, 1, label[:, None], "
                                 "-1), out of place")
    emit({"phase": "kernel", "kernel": "rtc", "nvrtc": list(
        rtc_driver.nvrtc_version()), "options": rtc_driver.compile_options(),
          "tests": tests, "test_compile_ms": compile_ms,
          "cache": {"same_object": True, "compiles": rtc_driver.compiles},
          "syntax_error": syntax_error[:4], "refused_launch": refused,
          "softmax_cases": cases, "max_abs_err": worst,
          "softmax_tol": {"atol": RTC_SOFTMAX_ATOL, "rtol": RTC_SOFTMAX_RTOL,
                          "floor": RTC_SOFTMAX_FLOOR,
                          "row_sum": RTC_SOFTMAX_ROW_SUM},
          "timings": timings})
    return worst, timings


def phase_serve(cfg=LM, serve=SERVE, device=None, ref_device="cpu",
                seed=SEED):
    """The generate path end to end. ``device`` None = the card (the
    port's default); the reference prefill runs on ``ref_device``, where
    flash_attention takes its plain version."""
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.serving import generate as gen

    params = lm_arg_params(cfg, seed)
    spec = gen.DecodeSpec(num_heads=cfg["heads"],
                          num_kv_heads=cfg["kv_heads"])
    model = gen.DecodeModel.from_arg_params(params, spec, device=device)
    config = gen.GenerateConfig(
        num_heads=cfg["heads"], num_kv_heads=cfg["kv_heads"],
        slots=serve["slots"], max_context=serve["max_context"],
        prefill_buckets=serve["prefill_buckets"],
        max_new_tokens=serve["max_new_tokens"], eos_id=None, capture=False,
        paged=False, kv_dtype="f32", quant_weights="", spec=False)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg["vocab"], n).tolist()
               for n in serve["prompt_lens"]]
    sched = gen.DecodeScheduler(model, config)
    sched.start()
    records = []
    try:
        fa.flash_attention.launches = 0
        t0 = time.monotonic()
        streams = [sched.submit(p) for p in prompts]
        threads = []
        for s in streams:
            rec = {"stream": s, "times": [], "tokens": []}
            records.append(rec)

            def consume(rec=rec):
                for tok in rec["stream"]:
                    rec["times"].append(time.monotonic())
                    rec["tokens"].append(tok)

            th = threading.Thread(target=consume, daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=600)
        wall = time.monotonic() - t0
        launches = fa.flash_attention.launches
        stats = sched.stats()
    finally:
        sched.stop()
    want = serve["max_new_tokens"]
    for rec, th in zip(records, threads):
        s = rec["stream"]
        if th.is_alive() or s.finish_reason != "max_tokens" \
                or len(rec["tokens"]) != want:
            raise RuntimeError("stream of %d prompt tokens ended %r with %d "
                               "tokens" % (s.prompt_len, s.finish_reason,
                                           len(rec["tokens"])))
    expected = len(prompts) * cfg["layers"]
    if launches != expected:
        raise RuntimeError("flash kernel ran %d times in the serve phase, "
                           "want %d" % (launches, expected))

    # first-token logits: the served program vs the port's plain path on
    # the reference device, same numpy weights
    ref_model = gen.DecodeModel.from_arg_params(params, spec,
                                                device=ref_device)
    ref_progs = gen.DecodePrograms(ref_model, 1, serve["max_context"],
                                   serve["prefill_buckets"])
    checks = []
    for n in serve["check_lens"]:
        i = serve["prompt_lens"].index(n)
        got = sched.programs.prefill(prompts[i])[0].float().cpu()
        ref = ref_progs.prefill(prompts[i])[0].float().cpu()
        err = float((got - ref).abs().max())
        tok_ref = int(ref.argmax())
        if err > 1e-3 or records[i]["tokens"][0] != tok_ref:
            raise RuntimeError(
                "prompt %d: first-token logits differ by %g from the plain "
                "path (token %d vs %d)" % (n, err, records[i]["tokens"][0],
                                           tok_ref))
        checks.append({"prompt_len": n, "max_abs_err": err,
                       "token": tok_ref})
    gaps = [b - a for rec in records
            for a, b in zip(rec["times"], rec["times"][1:])]
    total = sum(len(rec["tokens"]) for rec in records)
    result = {"phase": "serve", "requests": len(prompts),
              "prompt_lens": list(serve["prompt_lens"]),
              "ttft_ms": [(rec["times"][0] - rec["stream"].submitted) * 1e3
                          for rec in records],
              "decode_ms_per_step": float(np.median(gaps)) * 1e3,
              "tokens_per_s": total / wall, "wall_s": wall,
              "steps": stats["steps"], "flash_launches": launches,
              "first_token_check": checks}
    emit(result)
    return launches


def _counters():
    """The train phase's counters: name -> wrappers whose launches sum
    under it (the fused updates' scalar and device-lr entry points are one
    kernel each)."""
    from mxnet_tpu_torch.ops.kernels import flash_attention as fa
    from mxnet_tpu_torch.ops.kernels import fused_update as fu

    return {"flash_attention_fwd": (fa.flash_attention,),
            "flash_attention_bwd_dq": (fa.flash_attention_bwd_dq,),
            "flash_attention_bwd_dkv": (fa.flash_attention_bwd_dkv,),
            "sgd_mom_update": (fu.sgd_mom_update, fu.sgd_mom_update_lr),
            "adam_update": (fu.adam_update, fu.adam_update_lr)}


def _count(counters):
    return {k: sum(c.launches for c in cs) for k, cs in counters.items()}


def _types(counters):
    """name -> {type: launches} of the counters that count by type."""
    out = {}
    for k, cs in counters.items():
        for c in cs:
            for key, n in c.launches_by_dtype.items():
                out.setdefault(k, {})[key] = out.get(k, {}).get(key, 0) + n
    return out


def _require_types(phase, types, launches, dtype, names):
    """Each of ``names`` launched only its ``dtype`` instantiation: a step
    that quietly ran another type would hide the kernels of its own."""
    want = {k: {dtype: launches[k]} for k in names if launches[k]}
    got = {k: types.get(k, {}) for k in names if launches[k] or k in types}
    if got != want:
        raise RuntimeError("%s phase launched by type %s, want %s"
                           % (phase, got, want))


def _zero(counters):
    from mxnet_tpu_torch.ops.kernels import _launches

    for cs in counters.values():
        for c in cs:
            _launches.reset(c)


def _train_steps(torch, exe, names, updater, steps, sync):
    """``steps`` forward/backward/update rounds; (losses, seconds each)."""
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        exe.forward(is_train=True)
        exe.backward()
        lm_update(exe, names, updater)
        loss = float(exe.outputs[0].asnumpy())
        if sync:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss)
    return losses, secs


def _fused_steps(torch, run, steps, sync):
    """``steps`` calls of a fused step's ``run`` (:func:`lm_train_step`);
    (losses, seconds each). The loss is read after the step, from the
    step's own copy."""
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        outs = run()
        loss = float(outs[0])
        if sync:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(loss)
    return losses, secs


def _peak(torch, on_card):
    """Peak bytes allocated since the last reset (a captured graph's pool
    counts: its blocks stay allocated) and reserved now."""
    if not on_card:
        return {}
    return {"max_memory_allocated": torch.cuda.max_memory_allocated(),
            "memory_reserved": torch.cuda.memory_reserved()}


def _fresh(torch, on_card):
    """Drop what an earlier run left and reset the peak."""
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _equal_params(got, want):
    """(bit for bit?, worst |difference|, its name, how many differ) of two
    name -> host array dicts."""
    diff = {n: float(np.abs(got[n].astype(np.float64) - want[n]).max())
            for n in want}
    worst = max(diff, key=diff.get)
    return (all(np.array_equal(got[n], want[n]) for n in want),
            diff[worst], worst, sum(d > 0 for d in diff.values()))


def _train_check_bf16(torch, cfg, train, params, device, ref_device, f32):
    """The bf16 fused step at the check's size, card against the port's
    CPU path, after ``check_steps`` SGD steps: the losses within
    TRAIN_BF16_LOSS and the parameters within TRAIN_BF16_SPREAD times the
    CPU's own bf16-to-f32 distance (``f32``: the f32 check's CPU losses and
    parameters). The control, the same step with the card in f32 through
    the same comparison, must fail the loss gate, or the gate could not
    tell a bf16 step from an f32 one."""
    cb, cs = train["check_batch"], train["check_seq"]

    def run(dev, dtype):
        exe, names = lm_train_executor(cfg, cb, cs, dev, dtype)
        exe.copy_params_from(params)
        lm_feed(exe, cfg, SEED + 3)
        step, _ = lm_train_step(exe, names, lm_updater("sgd", train, names))
        losses, _ = _fused_steps(torch, step, train["check_steps"], False)
        return losses, {n: exe.arg_dict[n].asnumpy() for n in names}

    ref_l, ref_p = run(ref_device, "bfloat16")
    f32_l, f32_p = f32
    loss_spread = max(abs(a - b) for a, b in zip(ref_l, f32_l))
    param_spread = max(float(np.abs(ref_p[n] - f32_p[n]).max())
                       for n in ref_p)

    def reading(dtype):
        got_l, got_p = run(device, dtype)
        loss_err = max(abs(a - b) for a, b in zip(got_l, ref_l))
        param_err = max(float(np.abs(got_p[n] - ref_p[n]).max())
                        for n in ref_p)
        return {"losses": got_l, "loss_abs_err": loss_err,
                "param_max_abs_err": param_err,
                "loss_x_spread": loss_err / loss_spread if loss_spread
                else None,
                "param_x_spread": param_err / param_spread if param_spread
                else None,
                "passes": bool(loss_err <= TRAIN_BF16_LOSS * loss_spread
                               and param_err
                               <= TRAIN_BF16_SPREAD * param_spread)}

    got, control = reading("bfloat16"), reading(None)
    if not got["passes"]:
        raise RuntimeError(
            "train bf16 check: losses %s vs %s (|err| %g, gate %g x the CPU's "
            "bf16-to-f32 %g), parameters max abs err %g (gate %g x %g)"
            % (got["losses"], ref_l, got["loss_abs_err"], TRAIN_BF16_LOSS,
               loss_spread, got["param_max_abs_err"], TRAIN_BF16_SPREAD,
               param_spread))
    if control["passes"]:
        raise RuntimeError(
            "train bf16 check: the f32 control passes the gate too (loss "
            "|err| %g, parameters %g): it cannot tell bf16 from f32"
            % (control["loss_abs_err"], control["param_max_abs_err"]))
    return dict(got, batch=cb, seq=cs, sgd_steps=train["check_steps"],
                ref_losses=ref_l, cpu_bf16_to_f32_loss=loss_spread,
                cpu_bf16_to_f32_param=param_spread, f32_control=control,
                gate={"loss": TRAIN_BF16_LOSS, "param": TRAIN_BF16_SPREAD,
                      "of": "the CPU's bf16-to-f32 distance"})


def _train_run(torch, cfg, train, device, seed, capture, on_card, counters):
    """The run: bench.py's bf16 LM step through ``make_train_step``
    (``capture`` or eager), 5 SGD-momentum then 3 Adam steps from Xavier
    weights, then ``timed_steps`` more Adam steps for the step time.
    Returns (losses, parameters on the host, launches of the 8 steps,
    seconds of the timed steps, stats of the steps, executor facts)."""
    b, t = train["batch"], train["seq"]
    exe, names = lm_train_setup(cfg, train, device, seed)
    losses, stats = [], {}
    _zero(counters)
    for kind, steps in (("sgd", train["sgd_steps"]),
                        ("adam", train["adam_steps"])):
        if kind == "adam":
            del run, step   # the SGD step's graph and its pool
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
        with cuda_graph(capture):
            run, step = lm_train_step(exe, names,
                                      lm_updater(kind, train, names))
        losses += _fused_steps(torch, run, steps, on_card)[0]
        stats[kind] = step.stats()
    launches = _count(counters), _types(counters)
    params = {n: exe.arg_dict[n].asnumpy() for n in names}
    _, secs = _fused_steps(torch, run, train["timed_steps"], on_card)
    stats["adam"] = step.stats()
    facts = {"parameters": len(names),
             "elements": int(sum(exe.arg_dict[n].size for n in names)),
             "batch": b, "seq": t}
    del exe, run, step
    return losses, params, launches, secs, stats, facts


def _require_captured(phase, stats, on_card):
    """On the card every step of the phase's run must have taken the
    captured path: warm-up, one capture, replays."""
    if not on_card:
        return
    for st in stats:
        if st["path"] != "captured" or st["captures"] != 1 or \
                st["replays"] < 1:
            raise RuntimeError("%s phase did not take the captured path: %s"
                               % (phase, st))


def phase_train(cfg=LM, train=TRAIN, device=None, ref_device="cpu",
                seed=SEED):
    """The training path end to end. ``device`` None = the card; the
    card-vs-reference checks run the same weights on ``ref_device``, where
    every wrapper takes its plain version."""
    import torch

    # 1. card vs the port's CPU path: same weights, same batch, 2 SGD steps
    # through forward / backward / Updater, f32
    params = lm_arg_params(cfg, seed)
    cb, cs = train["check_batch"], train["check_seq"]
    runs = []
    for dev in (device, ref_device):
        exe, names = lm_train_executor(cfg, cb, cs, dev)
        exe.copy_params_from(params)
        lm_feed(exe, cfg, seed + 3)
        losses, _ = _train_steps(torch, exe, names,
                                 lm_updater("sgd", train, names),
                                 train["check_steps"], sync=False)
        runs.append((losses, {n: exe.arg_dict[n].asnumpy() for n in names}))
        del exe
    (got_l, got_p), (ref_l, ref_p) = runs
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got_l, ref_l))
    param_err = max(float(np.abs(got_p[n] - ref_p[n]).max()) for n in ref_p)
    if not loss_err <= TRAIN_LOSS_RTOL or not param_err <= TRAIN_PARAM_ATOL:
        raise RuntimeError(
            "train check: losses %s vs %s (rel err %g, tol %g), parameters "
            "max abs err %g (tol %g)" % (got_l, ref_l, loss_err,
                                         TRAIN_LOSS_RTOL, param_err,
                                         TRAIN_PARAM_ATOL))
    # 2. the same in bf16 through the fused step, held to the CPU's own
    # bf16-to-f32 distance
    check_bf16 = _train_check_bf16(torch, cfg, train, params, device,
                                   ref_device, (ref_l, ref_p))
    del params, runs, got_p, ref_p

    # 3. the run: bf16, captured on the card, exact launches
    on_card = device is None or torch.device(device).type == "cuda"
    counters = _counters()
    _fresh(torch, on_card)
    losses, got, (launches, types), secs, stats, facts = _train_run(
        torch, cfg, train, device, seed, True, on_card, counters)
    memory = _peak(torch, on_card)
    steps = train["sgd_steps"] + train["adam_steps"]
    want = {"flash_attention_fwd": cfg["layers"] * steps,
            "flash_attention_bwd_dq": cfg["layers"] * steps,
            "flash_attention_bwd_dkv": cfg["layers"] * steps,
            "sgd_mom_update": facts["parameters"] * train["sgd_steps"],
            "adam_update": facts["parameters"] * train["adam_steps"]}
    if launches != want:
        raise RuntimeError("train phase launched %s, want %s"
                           % (launches, want))
    _require_types("train", types, launches, train["dtype"],
                   [k for k in want if k.startswith("flash")])
    if not all(np.isfinite(losses)):
        raise RuntimeError("train phase: non-finite loss in %s" % losses)
    _require_captured("train", stats.values(), on_card)

    # 4. the same run eagerly: the captured steps must land on the same
    # parameters, bit for bit
    _fresh(torch, on_card)
    e_losses, e_got, _, e_secs, e_stats, _ = _train_run(
        torch, cfg, train, device, seed, False, on_card, counters)
    e_memory = _peak(torch, on_card)
    same, worst, worst_name, differ = _equal_params(got, e_got)
    if not same or e_losses != losses:
        raise RuntimeError(
            "train phase: the captured steps land %g from the eager ones "
            "(%s, %d parameters differ; losses %s vs %s)"
            % (worst, worst_name, differ, losses, e_losses))
    del got, e_got
    step_s, eager_s = float(np.median(secs)), float(np.median(e_secs))
    b, t = facts["batch"], facts["seq"]
    result = {"phase": "train", "batch": b, "seq": t,
              "dtype": train["dtype"], "path": "captured", "steps": stats,
              "parameters": facts["parameters"],
              "elements": facts["elements"],
              "check": {"batch": cb, "seq": cs, "sgd_steps":
                        train["check_steps"], "losses": got_l,
                        "ref_losses": ref_l, "loss_rel_err": loss_err,
                        "param_max_abs_err": param_err,
                        "loss_rtol": TRAIN_LOSS_RTOL,
                        "param_atol": TRAIN_PARAM_ATOL},
              "check_bf16": check_bf16, "losses": losses,
              "timed_step_ms": [x * 1e3 for x in secs],
              "median_step_ms": step_s * 1e3,
              "tokens_per_s": b * t / step_s,
              "eager": {"timed_step_ms": [x * 1e3 for x in e_secs],
                        "median_step_ms": eager_s * 1e3,
                        "tokens_per_s": b * t / eager_s,
                        "steps": e_stats, **e_memory},
              "captured_vs_eager": {"bit_for_bit": same,
                                    "losses_equal": True},
              "launches": launches, "launches_by_type": types, **memory}
    emit(result)
    return launches


def _resnet_counters():
    from mxnet_tpu_torch.ops.kernels import conv_wgrad as cw
    from mxnet_tpu_torch.ops.kernels import fused_update as fu

    return {"conv_wgrad_partial": (cw.conv_wgrad_partial,),
            "conv_wgrad_reduce": (cw.conv_wgrad_reduce,),
            "conv_wgrad_repack": (cw.repack,),
            "sgd_mom_update": (fu.sgd_mom_update, fu.sgd_mom_update_lr)}


def resnet_wgrad_launches(per_step, steps, repacks=False):
    """conv_wgrad's launches over ``steps`` steps of a model with
    ``per_step`` 3x3 convolutions: every call launches one partial kernel
    (whatever its route) and one reduce kernel; with ``repacks`` (bf16 on
    the card, where every ResNet-50 shape takes the wgmma route) the repack
    kernel once for x and once for dy (NCHW views, never the wgmma
    operand's form)."""
    return {"conv_wgrad_partial": per_step * steps,
            "conv_wgrad_reduce": per_step * steps,
            "conv_wgrad_repack": 2 * per_step * steps if repacks else 0}


def _fit_timed(torch, mod, it, kwargs, on_card):
    """``mod.fit(it, **kwargs)`` with a synchronized time and the metric
    after each batch: (ms from each batch's end to the next's, the first
    batch's ms, the metrics)."""
    times, metrics = [], []

    def record(param):
        if on_card:
            torch.cuda.synchronize()
        times.append(time.perf_counter())
        metrics.append({k: float(v) for k, v in
                        param.eval_metric.get_name_value()})

    t0 = time.perf_counter()
    mod.fit(it, batch_end_callback=record, **kwargs)
    return ([(b - a) * 1e3 for a, b in zip(times, times[1:])],
            (times[0] - t0) * 1e3, metrics)


def _steady_ms(step_ms, on_card):
    """The step times of replays: on the card the first CAPTURE_WARMUP
    batch-to-batch times hold the second warm-up call and the capture."""
    from mxnet_tpu_torch.executor import CAPTURE_WARMUP

    steady = step_ms[CAPTURE_WARMUP:] if on_card else step_ms
    return float(np.median(steady or step_ms))


def _eager_twin(torch, setup, kwargs, on_card, want, what):
    """The run of a captured ``Module.fit`` again with the fused step
    eager (``MXNET_CUDA_GRAPH=0``) from the same set-up: its parameters
    and aux states must equal ``want`` (the captured run's) bit for bit.
    Returns the eager run's record."""
    _fresh(torch, on_card)
    with cuda_graph(False):
        mod, it, init = setup()
        step_ms, first_ms, _ = _fit_timed(torch, mod, it, kwargs(init),
                                          on_card)
        stats = mod.fit_step_stats()
        got = _host_state(mod)
    memory = _peak(torch, on_card)
    del mod
    same_args = _equal_params(got[0], want[0])
    same_aux = _equal_params(got[1], want[1]) if want[1] else (True, 0.0,
                                                               None, 0)
    if not (same_args[0] and same_aux[0]):
        raise RuntimeError(
            "%s: the captured steps land %g (%s) / aux %g (%s) from the "
            "eager ones" % (what, same_args[1], same_args[2], same_aux[1],
                            same_aux[2]))
    return {"path": stats["path"], "steps": stats,
            "step_ms": step_ms, "first_batch_ms": first_ms,
            "median_step_ms": float(np.median(step_ms)), **memory}


def _host_state(mod):
    """Copies of a module's parameters and aux states, by name."""
    args, aux = mod.get_params()
    return ({n: np.array(a.asnumpy()) for n, a in args.items()},
            {n: np.array(a.asnumpy()) for n, a in aux.items()})


def _fit_recorded(mod, it, init, kwargs):
    """``mod.fit(it, **kwargs)`` (one epoch) from ``init`` (binding and
    initializing first if the set-up has not); returns the parameters and
    aux states before the first step and after each batch, and the metric
    after each batch."""
    if not mod.binded:
        mod.bind(it.provide_data, it.provide_label)
    mod.init_params(init)
    states, metrics = [_host_state(mod)], []

    def record(param):
        states.append(_host_state(mod))
        metrics.append({k: float(v) for k, v in
                        param.eval_metric.get_name_value()})

    mod.fit(it, batch_end_callback=record, **kwargs)
    return states, metrics


def _change_errs(before, after, ref_before, ref_after):
    """name -> tools/resnet.py change_err of each array's change."""
    return {n: change_err(after[n] - before[n].astype(np.float64),
                          ref_after[n] - ref_before[n].astype(np.float64))
            for n in ref_after}


def phase_resnet(cfg=RESNET, device=None, ref_device="cpu", seed=SEED):
    """ResNet-50 through ``Module.fit``. ``device`` None = the card; the
    card-vs-reference check runs the same weights and batches on
    ``ref_device``, where every wrapper takes its plain version."""
    import torch

    # 1. card vs the port's CPU path: same init, same 2 batches of 2
    cb, cs = cfg["check_batch"], cfg["check_steps"]
    runs = []
    for dev in (device, ref_device):
        mod, it, init = resnet_setup(cfg, cb, cs, dev, seed)
        runs.append(_fit_recorded(mod, it, init, fit_args(cfg, init)))
    (got_s, got_m), (ref_s, ref_m) = runs
    init_err = max(float(np.abs(got_s[0][0][n] - ref_s[0][0][n]).max())
                   for n in ref_s[0][0])
    upd = [_change_errs(got_s[0][0], got_s[b][0], ref_s[0][0], ref_s[b][0])
           for b in (1, 2)]
    aux = [_change_errs(got_s[0][1], got_s[b][1], ref_s[0][1], ref_s[b][1])
           for b in (1, 2)]
    ce = [abs(g["cross-entropy"] - r["cross-entropy"]) / r["cross-entropy"]
          for g, r in zip(got_m, ref_m)]
    failures = []
    if init_err != 0.0:
        failures.append("initial weights differ by %g" % init_err)
    worst_upd = max(upd[0], key=upd[0].get)
    if not upd[0][worst_upd] <= RESNET_UPDATE:
        failures.append("batch-1 update of %s off by %g (tol %g)"
                        % (worst_upd, upd[0][worst_upd], RESNET_UPDATE))
    worst_aux = max(aux[0], key=aux[0].get)
    if not aux[0][worst_aux] <= RESNET_AUX:
        failures.append("batch-1 change of %s off by %g (tol %g)"
                        % (worst_aux, aux[0][worst_aux], RESNET_AUX))
    if got_m[0]["accuracy"] != ref_m[0]["accuracy"]:
        failures.append("batch-1 accuracy %s vs %s" % (
            got_m[0]["accuracy"], ref_m[0]["accuracy"]))
    for b, (err, tol) in enumerate(zip(ce, RESNET_CE)):
        if not err <= tol:
            failures.append("batch-%d cross-entropy off by %g (tol %g)"
                            % (b + 1, err, tol))
    if failures:
        raise RuntimeError("resnet check: " + "; ".join(failures))
    wgrad_names = [n for n in upd[0] if ref_s[0][0][n].shape[-2:] == (3, 3)]
    check = {"batch": cb, "batches": cs, "metrics": got_m,
             "ref_metrics": ref_m, "ce_rel_err": ce,
             "update_err": [{"worst": max(u.values()),
                             "worst_name": max(u, key=u.get),
                             "median": float(np.median(list(u.values()))),
                             "worst_3x3_weight": max(
                                 u[n] for n in wgrad_names)} for u in upd],
             "aux_err": [{"worst": max(a.values()),
                          "median": float(np.median(list(a.values())))}
                         for a in aux],
             "tol": {"update": RESNET_UPDATE, "aux": RESNET_AUX,
                     "ce": RESNET_CE}}
    del runs, got_s, ref_s

    # 2. the run: one epoch of `batches` batches of `batch`, in bench.py's
    # compute type, through the captured fused step
    on_card = device is None or torch.device(device).type == "cuda"

    def setup():
        return resnet_setup(cfg, cfg["batch"], cfg["batches"], device, seed,
                            compute_dtype=cfg["dtype"])

    mod, it, init = setup()
    counters = _resnet_counters()
    _fresh(torch, on_card)
    _zero(counters)
    step_ms, first_ms, metrics = _fit_timed(torch, mod, it,
                                            fit_args(cfg, init), on_card)
    launches, types = _count(counters), _types(counters)
    memory = _peak(torch, on_card)
    stats = mod.fit_step_stats()
    steps = cfg["batches"]
    state = _host_state(mod)
    args, aux = state
    n_params = len(args)
    per_step = wgrad_convs(mod.symbol)
    want = dict(resnet_wgrad_launches(
        per_step, steps, on_card and cfg["dtype"] == "bfloat16"),
        sgd_mom_update=n_params * steps)
    if launches != want:
        raise RuntimeError("resnet phase launched %s, want %s"
                           % (launches, want))
    _require_types("resnet", types, launches, cfg["dtype"],
                   ["conv_wgrad_partial"])
    ce_run = [m["cross-entropy"] for m in metrics]
    if len(metrics) != steps or not all(np.isfinite(ce_run)):
        raise RuntimeError("resnet phase: %d batches, cross-entropy %s"
                           % (len(metrics), ce_run))
    _require_captured("resnet", [stats], on_card)
    del mod
    eager = _eager_twin(torch, setup, lambda i: fit_args(cfg, i), on_card,
                        state, "resnet phase")
    median_ms = _steady_ms(step_ms, on_card)
    result = {"phase": "resnet", "depth": cfg["depth"],
              "classes": cfg["classes"], "image": list(cfg["image"]),
              "batch": cfg["batch"], "batches": steps,
              "dtype": cfg["dtype"], "path": stats["path"], "steps": stats,
              "parameters": n_params,
              "elements": int(sum(a.size for a in args.values())),
              "aux_states": len(aux),
              "wgrad_convs_per_step": per_step, "check": check,
              "metrics": metrics, "first_batch_ms": first_ms,
              "step_ms": step_ms, "median_step_ms": median_ms,
              "images_per_s": cfg["batch"] / median_ms * 1e3,
              "eager": dict(eager, images_per_s=cfg["batch"]
                            / eager["median_step_ms"] * 1e3),
              "captured_vs_eager": {"bit_for_bit": True},
              "launches": launches, "launches_by_type": types, **memory}
    emit(result)
    return launches


def _reset_peak(torch):
    """Collect the modules an earlier check left in reference cycles (a
    fit's BatchEndParam holds its locals), then reset the card's peak
    memory; returns the bytes still allocated, the run's starting point."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def memory_holders(torch, top=8):
    """What holds the card's memory: the ``top`` largest active blocks of
    ``torch.cuda.memory_snapshot()``, the live CUDA tensors found by
    ``gc`` grouped by shape and type, largest first, each with the types
    of the objects that refer to it (a dict's owners named through it),
    and the allocated bytes that no live tensor holds (PyTorch's cuBLAS
    workspaces, one a stream that ran a product, are such bytes). It
    reads and frees nothing."""
    gc.collect()
    blocks = sorted((b["size"] for seg in torch.cuda.memory_snapshot()
                     for b in seg["blocks"]
                     if b["state"] == "active_allocated"), reverse=True)
    groups = {}
    for obj in gc.get_objects():
        if issubclass(type(obj), torch.Tensor) and obj.is_cuda:
            key = "%s %s" % (tuple(obj.shape), str(obj.dtype)[6:])
            g = groups.setdefault(key, [0, 0, []])
            g[0] += obj.untyped_storage().nbytes()
            g[1] += 1
            if len(g[2]) < 2:
                g[2].append(obj)
    mine = {id(groups)} | {id(g) for g in groups.values()} | {
        id(g[2]) for g in groups.values()}

    def owners(obj, depth):
        names = []
        for r in gc.get_referrers(obj):
            if id(r) in mine or type(r).__name__ == "frame":
                continue
            if isinstance(r, dict) and depth:
                names += ["%s.__dict__" % o for o in owners(r, depth - 1)]
            else:
                names.append(type(r).__name__)
        return names

    largest = sorted(groups.items(), key=lambda kv: -kv[1][0])[:top]
    tensors = [{"tensor": key, "bytes": nbytes, "count": count,
                "referrers": sorted(set(sum((owners(t, 1) for t in ts),
                                           [])))}
               for key, (nbytes, count, ts) in largest]
    allocated = torch.cuda.memory_allocated()
    live = sum(g[0] for g in groups.values())
    return {"allocated": allocated,
            "largest_blocks": blocks[:top],
            "live_cuda_tensor_bytes": live,
            "largest_tensors": tensors,
            "untracked_bytes": allocated - live}


def _lstm_check(what, cfg, cs, setups, fit_args=lstm_fit_args):
    """Fit the LSTM LM of each of the two ``setups`` (each returns a fresh
    (module, iterator, initializer)) for its ``cs`` batches with
    ``fit_args(cfg, init)``, and hold the first run against the second:
    after each batch, each parameter's update within LSTM_UPDATE and the
    perplexity within LSTM_PPL; the initial weights equal. Raises naming
    ``what``; returns the record."""
    runs = []
    for setup in setups:
        mod, it, init = setup()
        batch = it.batch_size
        runs.append(_fit_recorded(mod, it, init, fit_args(cfg, init)))
        del mod
    (got_s, got_m), (ref_s, ref_m) = runs
    init_err = max(float(np.abs(got_s[0][0][n] - ref_s[0][0][n]).max())
                   for n in ref_s[0][0])
    upd = [_change_errs(got_s[0][0], got_s[b][0], ref_s[0][0], ref_s[b][0])
           for b in range(1, cs + 1)]
    ppl = [abs(g["Perplexity"] - r["Perplexity"]) / r["Perplexity"]
           for g, r in zip(got_m, ref_m)]
    failures = []
    if init_err != 0.0:
        failures.append("initial weights differ by %g" % init_err)
    for b, (u, p) in enumerate(zip(upd, ppl)):
        worst = max(u, key=u.get)
        if not u[worst] <= LSTM_UPDATE:
            failures.append("batch-%d update of %s off by %g (tol %g)"
                            % (b + 1, worst, u[worst], LSTM_UPDATE))
        if not p <= LSTM_PPL:
            failures.append("batch-%d perplexity off by %g (tol %g)"
                            % (b + 1, p, LSTM_PPL))
    if len(got_m) != cs or len(ref_m) != cs:
        failures.append("%d / %d batches recorded, want %d"
                        % (len(got_m), len(ref_m), cs))
    if failures:
        raise RuntimeError(what + ": " + "; ".join(failures))
    return {"batch": batch, "batches": cs, "metrics": got_m,
            "ref_metrics": ref_m, "perplexity_rel_err": ppl,
            "update_err": upd,
            "tol": {"update": LSTM_UPDATE, "perplexity": LSTM_PPL}}


def phase_lstm(cfg=LSTM_LM, device=None, ref_device="cpu", seed=SEED):
    """The LSTM LM through ``Module.fit`` and ``Module.score``. ``device``
    None = the card; the card-vs-reference check runs the same weights and
    batches on ``ref_device``, where lstm_step takes its plain version."""
    import torch
    from mxnet_tpu_torch import metric
    from mxnet_tpu_torch.ops.kernels import lstm as kl

    # 1. card vs the port's CPU path: same init, same 2 batches of 8
    cb, cs = cfg["check_batch"], cfg["check_steps"]
    check = _lstm_check(
        "lstm check", cfg, cs,
        [lambda dev=dev: lstm_setup(cfg, cb, cs, dev, seed)
         for dev in (device, ref_device)])

    # 2. the run: one epoch of `batches` batches of `batch` through the
    # captured fused step, then score
    on_card = device is None or torch.device(device).type == "cuda"

    def setup():
        return lstm_setup(cfg, cfg["batch"], cfg["batches"], device, seed)

    mod, it, init = setup()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    sync()
    if on_card:
        emit({"phase": "lstm_memory", "when": "before the peak reset",
              **memory_holders(torch)})
    start_memory = _reset_peak(torch) if on_card else None
    kl.lstm_step.launches = 0
    step_ms, first_ms, metrics = _fit_timed(
        torch, mod, it, lstm_fit_args(cfg, init), on_card)
    fit_launches = kl.lstm_step.launches
    stats = mod.fit_step_stats()
    state = _host_state(mod)
    kl.lstm_step.launches = 0
    t1 = time.perf_counter()
    score = dict(mod.score(it, metric.Perplexity(ignore_label=None)))
    sync()
    score_s = time.perf_counter() - t1
    score_launches = kl.lstm_step.launches
    memory = _peak(torch, on_card)
    steps = cfg["batches"]
    want = lstm_steps(cfg, steps)
    if fit_launches != want or score_launches != want:
        raise RuntimeError("lstm phase launched lstm_step %d times in fit "
                           "and %d in score, want %d each"
                           % (fit_launches, score_launches, want))
    ppl_run = [m["Perplexity"] for m in metrics]
    if len(metrics) != steps or not all(np.isfinite(ppl_run)) \
            or not np.isfinite(score["Perplexity"]):
        raise RuntimeError("lstm phase: %d batches, perplexity %s, score %s"
                           % (len(metrics), ppl_run, score))
    _require_captured("lstm", [stats], on_card)
    args = state[0]
    del mod
    eager = _eager_twin(torch, setup, lambda i: lstm_fit_args(cfg, i),
                        on_card, state, "lstm phase")
    median_ms = _steady_ms(step_ms, on_card)
    tokens = cfg["batch"] * cfg["seq"]
    result = {"phase": "lstm", "vocab": cfg["vocab"], "embed": cfg["embed"],
              "hidden": cfg["hidden"], "layers": cfg["layers"],
              "seq": cfg["seq"], "batch": cfg["batch"], "batches": steps,
              "dtype": "float32", "path": stats["path"], "steps": stats,
              "parameters": len(args),
              "elements": int(sum(a.size for a in args.values())),
              "check": check, "metrics": metrics,
              "score": score, "score_ms_per_batch": score_s * 1e3 / steps,
              "first_batch_ms": first_ms,
              "step_ms": step_ms, "median_step_ms": median_ms,
              "tokens_per_s": tokens / median_ms * 1e3,
              "eager": dict(eager, tokens_per_s=tokens
                            / eager["median_step_ms"] * 1e3),
              "captured_vs_eager": {"bit_for_bit": True},
              "launches": {"fit": fit_launches, "score": score_launches},
              **memory}
    if on_card:
        result["start_memory_allocated"] = start_memory
    emit(result)
    return {"fit": fit_launches, "score": score_launches}


def phase_custom(cfg=LSTM_LM, device=None, ref_device="cpu", seed=SEED):
    """The LSTM LM with its SoftmaxOutput head replaced by the Custom
    ``rtc_softmax`` head (forward and backward rtc kernels) through
    ``Module.fit`` and ``Module.score``: (a) card against the port's CPU
    path (the twins) at the lstm check's size; (b) the rtc head against the
    built-in SoftmaxOutput head on ``device``, same weights and batches, at
    the run's batch; (c) the run, with exact launch counts of both rtc
    kernels and lstm_step. ``device`` None = the card."""
    import torch
    from mxnet_tpu_torch import metric
    from mxnet_tpu_torch.ops.kernels import lstm as kl
    from mxnet_tpu_torch.tools import rtc_softmax as rs

    cb, cs = cfg["check_batch"], cfg["check_steps"]
    b = cfg["batch"]

    def rtc_setup(dev, batch, batches):
        return lambda: lstm_setup(cfg, batch, batches, dev, seed,
                                  symbol=rs.lstm_rtc_symbol(cfg))

    # (a) card vs the port's CPU path: same init, same 2 batches of 8
    check_cpu = _lstm_check("custom check (a), card vs CPU", cfg, cs,
                            [rtc_setup(device, cb, cs),
                             rtc_setup(ref_device, cb, cs)])
    # (b) the rtc head vs SoftmaxOutput on the card: 2 batches of 128
    check_head = _lstm_check(
        "custom check (b), rtc head vs SoftmaxOutput", cfg, cs,
        [rtc_setup(device, b, cs),
         lambda: lstm_setup(cfg, b, cs, device, seed)])

    # (c) the run: one epoch of `batches` batches of `batch` through the
    # captured fused step, then score
    on_card = device is None or torch.device(device).type == "cuda"
    setup = rtc_setup(device, b, cfg["batches"])
    mod, it, init = setup()
    kern = rs.kernels(cfg["vocab"])
    bwd = [kern[k] for k in ("bwd", "bwd_vec") if k in kern]
    counters = [kern["fwd"], kl.lstm_step] + bwd

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def counts():
        """Launches by kernel; "bwd" sums the backward's two sources."""
        return {"fwd": kern["fwd"].launches,
                "bwd": sum(c.launches for c in bwd),
                "lstm_step": kl.lstm_step.launches}

    sync()
    start_memory = _reset_peak(torch) if on_card else None
    for c in counters:
        c.launches = 0
    step_ms, first_ms, metrics = _fit_timed(
        torch, mod, it, lstm_fit_args(cfg, init), on_card)
    fit_launches = counts()
    fit_vector = kern["bwd_vec"].launches if "bwd_vec" in kern else 0
    stats = mod.fit_step_stats()
    state = _host_state(mod)
    for c in counters:
        c.launches = 0
    t1 = time.perf_counter()
    score = dict(mod.score(it, metric.Perplexity(ignore_label=None)))
    sync()
    score_s = time.perf_counter() - t1
    score_launches = counts()
    memory = _peak(torch, on_card)
    steps = cfg["batches"]
    want_fit = {"fwd": steps, "bwd": steps,
                "lstm_step": lstm_steps(cfg, steps)}
    want_score = dict(want_fit, bwd=0)
    if fit_launches != want_fit or score_launches != want_score:
        raise RuntimeError("custom phase launched %s in fit and %s in "
                           "score, want %s and %s"
                           % (fit_launches, score_launches, want_fit,
                              want_score))
    if on_card and "bwd_vec" in kern and fit_vector != steps:
        raise RuntimeError("custom phase: %d of %d backward launches took "
                           "the vector source" % (fit_vector, steps))
    ppl_run = [m["Perplexity"] for m in metrics]
    if len(metrics) != steps or not all(np.isfinite(ppl_run)) \
            or not np.isfinite(score["Perplexity"]):
        raise RuntimeError("custom phase: %d batches, perplexity %s, score "
                           "%s" % (len(metrics), ppl_run, score))
    _require_captured("custom", [stats], on_card)
    del mod
    eager = _eager_twin(torch, setup, lambda i: lstm_fit_args(cfg, i),
                        on_card, state, "custom phase")
    median_ms = _steady_ms(step_ms, on_card)
    tokens = b * cfg["seq"]
    result = {"phase": "custom", "head": "Custom(op_type=rtc_softmax)",
              "vocab": cfg["vocab"], "embed": cfg["embed"],
              "hidden": cfg["hidden"], "layers": cfg["layers"],
              "seq": cfg["seq"], "batch": b, "batches": steps,
              "dtype": "float32", "path": stats["path"], "steps": stats,
              "check_vs_cpu": check_cpu,
              "check_vs_softmax_output": check_head, "metrics": metrics,
              "score": score, "score_ms_per_batch": score_s * 1e3 / steps,
              "first_batch_ms": first_ms,
              "step_ms": step_ms, "median_step_ms": median_ms,
              "tokens_per_s": tokens / median_ms * 1e3,
              "eager": dict(eager, tokens_per_s=tokens
                            / eager["median_step_ms"] * 1e3),
              "captured_vs_eager": {"bit_for_bit": True},
              "launches": {"fit": fit_launches, "score": score_launches},
              "bwd_vector_launches": fit_vector, **memory}
    if on_card:
        result["start_memory_allocated"] = start_memory
    emit(result)
    return {"fit": fit_launches, "score": score_launches}


def _bucket_fit(torch, mod, it, kwargs, on_card):
    """``mod.fit(it, **kwargs)`` with a synchronized time and the bucket
    and metric after each batch: (ms from each batch's end to the next's,
    the first batch's ms, bucket keys, metrics)."""
    times, keys, metrics = [], [], []

    def record(param):
        if on_card:
            torch.cuda.synchronize()
        times.append(time.perf_counter())
        keys.append(param.locals["data_batch"].bucket_key)
        metrics.append({k: float(v) for k, v in
                        param.eval_metric.get_name_value()})

    t0 = time.perf_counter()
    mod.fit(it, batch_end_callback=record, **kwargs)
    return ([(b - a) * 1e3 for a, b in zip(times, times[1:])],
            (times[0] - t0) * 1e3, keys, metrics)


def _by_bucket(step_ms, keys, batch):
    """Per bucket: the median eager step ms over its batches after its
    first (which binds the bucket's executor), and the tokens (padded)
    a second over the same batches."""
    seen, ms = set([keys[0]]), {}
    for key, t in zip(keys[1:], step_ms):
        if key in seen:
            ms.setdefault(key, []).append(t)
        seen.add(key)
    out = {str(k): {"median_ms": float(np.median(v)), "batches": len(v)}
           for k, v in sorted(ms.items())}
    tokens = sum(batch * k * len(v) for k, v in ms.items())
    total = sum(sum(v) for v in ms.values())
    return out, (tokens / total * 1e3 if total else None)


def _bucket_dropout_checks(torch, cfg, mod, batch, device, seed):
    """On ``device``: the LM's eval output at p = cfg["dropout"] equals the
    p = 0 output bit for bit on the same weights and batch; two training
    forwards after the same seed are equal and after another seed differ;
    the Dropout op over cfg["mask_elements"] elements keeps a share within
    5 sigma of 1 - p, each kept entry exactly x / (1 - p)."""
    from mxnet_tpu_torch import ndarray as nd
    from mxnet_tpu_torch import random as mrand
    from mxnet_tpu_torch.module import Module

    p = cfg["dropout"]
    args, aux = mod.get_params()
    key = batch.bucket_key
    outs = {}
    for drop in (p, 0.0):
        m = Module(lb.lm_symbol(cfg, key, drop), context=device)
        m.bind(batch.provide_data, batch.provide_label)
        m.init_params(arg_params=args, aux_params=aux)
        m.forward(batch, is_train=False)
        outs[drop] = m.get_outputs()[0].asnumpy()
        if drop:
            train = []
            for s in (seed, seed, seed + 1):
                mrand.seed(s)
                m.forward(batch, is_train=True)
                train.append(m.get_outputs()[0].asnumpy())
        del m
    failures = []
    if not np.array_equal(outs[p], outs[0.0]):
        failures.append("eval output at p = %g differs from p = 0" % p)
    if not np.array_equal(train[0], train[1]):
        failures.append("two training forwards after one seed differ")
    if np.array_equal(train[0], train[2]):
        failures.append("training forwards after two seeds are equal")
    n = cfg["mask_elements"]
    x = nd.array(np.random.RandomState(seed).uniform(
        0.5, 2.0, n).astype(np.float32), ctx=device)
    y = nd.Dropout(x, p=p, mode="always")
    kept = y._data != 0
    share = float(kept.float().mean())
    sigma = math.sqrt(p * (1 - p) / n)
    exact = bool(torch.equal(y._data[kept], (x._data / (1 - p))[kept]))
    if not abs(share - (1 - p)) <= 5 * sigma:
        failures.append("Dropout kept %.6f of %d, want %g +- %g"
                        % (share, n, 1 - p, 5 * sigma))
    if not exact:
        failures.append("a kept entry differs from x / (1 - p)")
    if failures:
        raise RuntimeError("bucketing dropout: " + "; ".join(failures))
    return {"eval_equals_p0": True, "same_seed_equal": True,
            "other_seed_differs": True, "bucket": key,
            "mask": {"elements": n, "kept_share": share,
                     "want": 1 - p, "five_sigma": 5 * sigma,
                     "kept_exact": exact}}


def _bucket_capture(torch, cfg, device, seed, on_card):
    """The LM at seq cfg["capture_seq"] with dropout through ``Module.fit``
    for cfg["capture_batches"] batches of cfg["batch"]: the fused step
    (captured on the card) against the same run eager, bit for bit; then
    two more steps on one batch from the same parameters, whose outputs
    must differ (the masks are drawn anew at each replay)."""
    from mxnet_tpu_torch import random as mrand
    from mxnet_tpu_torch.ops.kernels import fused_update as fu
    from mxnet_tpu_torch.ops.kernels import lstm as kl

    lcfg = dict(LSTM_LM, seq=cfg["capture_seq"], vocab=cfg["vocab"],
                embed=cfg["embed"], hidden=cfg["hidden"],
                layers=cfg["layers"])
    steps = cfg["capture_batches"]
    sym = lb.lm_symbol(cfg, lcfg["seq"], cfg["dropout"])

    def setup():
        made = lstm_setup(lcfg, cfg["batch"], steps, device, seed, symbol=sym)
        mrand.seed(seed + 5)
        return made

    mod, it, init = setup()
    counters = {"lstm_step": (kl.lstm_step,),
                "sgd_mom_update_lr": (fu.sgd_mom_update_lr,)}
    _zero(counters)
    step_ms, first_ms, metrics = _fit_timed(
        torch, mod, it, lb.fit_args(cfg, init), on_card)
    launches = _count(counters)
    stats = mod.fit_step_stats()
    state = _host_state(mod)
    _require_captured("bucketing capture", [stats], on_card)
    want = {"lstm_step": lstm_steps(lcfg, steps),
            "sgd_mom_update_lr": len(state[0]) * steps}
    if launches["lstm_step"] != want["lstm_step"] or (
            on_card and launches != want):
        raise RuntimeError("bucketing capture launched %s, want %s"
                           % (launches, want))
    # two steps on one batch from the same parameters: fresh masks
    it.reset()
    batch = next(iter(it))
    args, aux = mod.get_params()
    outs = []
    for _ in range(2):
        mod.set_params(args, aux)
        mod.fit_step(batch)
        outs.append(mod.get_outputs()[0].asnumpy())
    after = mod.fit_step_stats()
    if on_card and (after["captures"] != 1
                    or after["replays"] != stats["replays"] + 2):
        raise RuntimeError("bucketing capture: the two extra steps were not "
                           "replays of the one graph: %s" % after)
    if np.array_equal(outs[0], outs[1]):
        raise RuntimeError("bucketing capture: two steps on one batch give "
                           "the same output (the masks repeat)")
    del mod
    eager = _eager_twin(torch, setup, lambda i: lb.fit_args(cfg, i),
                        on_card, state, "bucketing capture")
    return {"seq": lcfg["seq"], "batch": cfg["batch"], "batches": steps,
            "dropout": cfg["dropout"], "path": stats["path"],
            "steps": stats, "after_two_more": after, "metrics": metrics,
            "step_ms": step_ms, "median_step_ms": _steady_ms(step_ms,
                                                             on_card),
            "first_batch_ms": first_ms, "launches": launches,
            "captured_vs_eager": {"bit_for_bit": True},
            "replays_differ": True, "eager": eager}


def phase_bucketing(cfg=BUCKETING, device=None, ref_device="cpu",
                    seed=SEED):
    """The bucketed LSTM LM through ``BucketingModule`` (``tools/
    lstm_bucketing.py``): (1) card vs the port's CPU path at p = 0,
    cfg["check_batch"] a batch over the buckets cfg["check_keys"]; (2) the
    run: one epoch of ``BucketSentenceIter`` at p = cfg["dropout"] with
    ``do_checkpoint`` and ``module_checkpoint(save_optimizer_states=True)``
    at its end, then ``score``, with exact lstm_step (f32) and sgd_mom_update
    launches; (3) the resume: a fresh BucketingModule from the checkpoint
    and its states and the uninterrupted module, each after the same seed,
    over batches of the buckets cfg["resume_keys"], bit for bit; (4)
    dropout on ``device`` (:func:`_bucket_dropout_checks`); (5) dropout in the
    captured step (:func:`_bucket_capture`). ``device`` None = the card."""
    import shutil
    import tempfile

    import torch
    from mxnet_tpu_torch import callback, metric, model
    from mxnet_tpu_torch import random as mrand
    from mxnet_tpu_torch.ops.kernels import fused_update as fu
    from mxnet_tpu_torch.ops.kernels import lstm as kl

    on_card = device is None or torch.device(device).type == "cuda"
    top = max(cfg["buckets"])

    # 1. card vs the port's CPU path, no dropout: the generators differ
    cb, keys = cfg["check_batch"], cfg["check_keys"]

    def check_setup(dev):
        def setup():
            mod, init = lb.bucketing_module(cfg, dev, 0.0, cb, seed)
            return mod, lb.pick_batches(lb.bucket_iter(cfg, cb, seed + 1),
                                        keys), init
        return setup

    check = _lstm_check("bucketing check, card vs CPU at p = 0", cfg,
                        len(keys), [check_setup(device),
                                    check_setup(ref_device)],
                        fit_args=lb.fit_args)
    check["buckets"] = list(keys)

    # 2. the run
    def sync():
        if on_card:
            torch.cuda.synchronize()

    work = tempfile.mkdtemp(prefix="bucketing-")
    try:
        batch = cfg["batch"]
        mod, init = lb.bucketing_module(cfg, device, cfg["dropout"], batch,
                                        seed)
        it = lb.bucket_iter(cfg, batch, seed + 1)
        master = lb.master_module(mod)
        ckpt, params_ck = os.path.join(work, "ck"), os.path.join(work, "lm")
        counters = {"lstm_step": (kl.lstm_step,),
                    "sgd_mom_update": (fu.sgd_mom_update,)}
        mrand.seed(seed)
        sync()
        start_memory = _reset_peak(torch) if on_card else None
        _zero(counters)
        step_ms, first_ms, fit_keys, metrics = _bucket_fit(
            torch, mod, it, dict(lb.fit_args(cfg, init), epoch_end_callback=[
                callback.do_checkpoint(params_ck),
                callback.module_checkpoint(master, ckpt,
                                           save_optimizer_states=True)]),
            on_card)
        fit_launches = _count(counters)
        fit_types = _types(counters)
        live = _host_state(mod)
        _zero(counters)
        score_keys = []
        t1 = time.perf_counter()
        score = dict(mod.score(
            it, metric.Perplexity(ignore_label=cfg["invalid_label"]),
            batch_end_callback=lambda p: score_keys.append(
                p.locals["eval_batch"].bucket_key)))
        sync()
        score_s = time.perf_counter() - t1
        score_launches = _count(counters)
        memory = _peak(torch, on_card)
        n_params = len(live[0])
        want_fit = {"lstm_step": lb.lstm_steps(cfg, fit_keys),
                    "sgd_mom_update": n_params * len(fit_keys)}
        want_score = {"lstm_step": lb.lstm_steps(cfg, score_keys),
                      "sgd_mom_update": 0}
        failures = []
        if fit_launches != want_fit or score_launches != want_score:
            failures.append("launched %s in fit and %s in score, want %s "
                            "and %s" % (fit_launches, score_launches,
                                        want_fit, want_score))
        if set(fit_types.get("lstm_step", {})) != {"float32"}:
            failures.append("lstm_step ran %s, want float32 only"
                            % fit_types.get("lstm_step"))
        per = {k: fit_keys.count(k) for k in cfg["buckets"]}
        if len(fit_keys) < 24 or min(per.values()) < 2:
            failures.append("the epoch ran %d batches, by bucket %s: want "
                            ">= 24 and every bucket twice" % (len(fit_keys),
                                                              per))
        ppl = [m["Perplexity"] for m in metrics]
        if not all(np.isfinite(ppl)) or not np.isfinite(score["Perplexity"]):
            failures.append("perplexity %s, score %s" % (ppl, score))
        # the checkpoints hold the stepped parameters
        for prefix in (ckpt, params_ck):
            _, ck_args, _ = model.load_checkpoint(prefix, 1)
            if not _equal_params({n: a.asnumpy() for n, a in
                                  ck_args.items()}, live[0])[0]:
                failures.append("%s-0001.params differs from the module's "
                                "parameters" % os.path.basename(prefix))
        if failures:
            raise RuntimeError("bucketing phase: " + "; ".join(failures))

        # 3. the resume, bit for bit
        more = lb.pick_batches(lb.bucket_iter(cfg, batch, seed + 2),
                               cfg["resume_keys"])
        mrand.seed(seed + 3)
        for b in more.batches:
            mod.fit_step(b)
        want = _host_state(mod)
        _, ck_args, ck_aux = model.load_checkpoint(ckpt, 1)
        resumed, _ = lb.bucketing_module(cfg, device, cfg["dropout"], batch,
                                         seed + 9)
        resumed.set_params(ck_args, ck_aux)
        resumed.init_optimizer(optimizer="sgd",
                               optimizer_params=lb.optimizer_params(cfg))
        lb.master_module(resumed).load_optimizer_states(ckpt + "-0001.states")
        mrand.seed(seed + 3)
        for b in more.batches:
            resumed.fit_step(b)
        got = _host_state(resumed)
        same = _equal_params(got[0], want[0])
        if not same[0]:
            raise RuntimeError("bucketing resume: %d parameters differ, the "
                               "worst %s by %g" % (same[3], same[2],
                                                   same[1]))
        resume = {"batches": [b.bucket_key for b in more.batches],
                  "bit_for_bit": True,
                  "files": sorted(os.listdir(work))}
        del resumed

        # 4. dropout on the card
        dropout = _bucket_dropout_checks(torch, cfg, mod, more.batches[0],
                                         device, seed)
        del mod, master
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 5. dropout in the captured step
    _fresh(torch, on_card)
    capture = _bucket_capture(torch, cfg, device, seed, on_card)

    by_bucket, tokens_per_s = _by_bucket(step_ms, fit_keys, batch)
    result = {"phase": "bucketing", "vocab": cfg["vocab"],
              "embed": cfg["embed"], "hidden": cfg["hidden"],
              "layers": cfg["layers"], "dropout": cfg["dropout"],
              "buckets": list(cfg["buckets"]), "batch": batch,
              "dtype": "float32", "path": "eager (BucketingModule)",
              "check": check, "bucket_sequence": fit_keys,
              "batches": len(fit_keys), "metrics": metrics,
              "score": score, "score_ms_per_batch":
                  score_s * 1e3 / max(len(score_keys), 1),
              "first_batch_ms": first_ms, "step_ms": step_ms,
              "step_ms_by_bucket": by_bucket,
              "tokens_per_s": tokens_per_s,
              "launches": {"fit": fit_launches, "score": score_launches,
                           "capture": capture["launches"]},
              "resume": resume, "dropout_checks": dropout,
              "capture": capture, **memory}
    if on_card:
        result["start_memory_allocated"] = start_memory
    emit(result)
    return {"lstm_step": fit_launches["lstm_step"]
            + score_launches["lstm_step"],
            "sgd_mom_update": fit_launches["sgd_mom_update"],
            "sgd_mom_update_lr": capture["launches"]["sgd_mom_update_lr"],
            "capture_lstm_step": capture["launches"]["lstm_step"]}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # the reference products run in full f32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    worst, timings = phase_kernel(torch)
    bwd_worst, bwd_timings = phase_kernel_bwd(torch)
    upd_worst, upd_timings = phase_kernel_update(torch)
    wgrad_worst, wgrad_timings, wgrad_step = phase_kernel_wgrad(torch)
    lstm_worst, lstm_timings, lstm_layer = phase_kernel_lstm(torch)
    rtc_worst, rtc_timings = phase_kernel_rtc(torch)
    serve_launches = phase_serve()
    train = phase_train()
    resnet = phase_resnet()
    lstm = phase_lstm()
    custom = phase_custom()
    bucketing = phase_bucketing()
    t = timings["serve"]["float32"]
    rows = [{
        "name": "flash_attention_fwd", "route": "cuda", "source": FA_SRC,
        "replaces": FA_REPLACES,
        "launches": serve_launches + train["flash_attention_fwd"],
        "launches_by_phase": {"serve": serve_launches,
                              "train": train["flash_attention_fwd"]},
        "max_abs_err": max(worst.values()), "max_err": worst,
        "dtype": "float32", "shape": t["shape"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "bfloat16": timings["serve"]["bfloat16"], "train": timings["train"],
        "bfloat16_main": timings["train_main"][TRAIN["dtype"]]}]
    # the backward runs on the main path only in the train phase: its
    # type and batch head the row
    t = {k: v for k, v in bwd_timings["train_main"].items() if k != "work"}
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda", "source": FA_BWD_SRC,
        "replaces": FA_BWD_REPLACES,
        "launches": train["flash_attention_bwd_dq"]
        + train["flash_attention_bwd_dkv"],
        "launches_by_kernel": {"dq": train["flash_attention_bwd_dq"],
                               "dkv": train["flash_attention_bwd_dkv"]},
        "max_abs_err": max(bwd_worst.values()), "max_err": bwd_worst,
        "dtype": TRAIN["dtype"], **t,
        "float32": {k: v for k, v in bwd_timings["float32"].items()
                    if k != "work"},
        "bfloat16_batch4": {k: v for k, v in bwd_timings["bfloat16"].items()
                            if k != "work"}})
    for kind in ("sgd_mom_update", "adam_update"):
        t = upd_timings[kind]
        by_phase = {"train": train[kind]}
        if kind in resnet:
            by_phase["resnet"] = resnet[kind]
        if kind in bucketing:
            # the Updater's scalar entry, and the captured step's lr entry
            by_phase["bucketing"] = bucketing[kind]
            by_phase["bucketing_capture"] = bucketing[kind + "_lr"]
        rows.append({
            "name": kind, "route": "cuda", "source": UPDATE_SRC,
            "replaces": UPDATE_REPLACES[kind],
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": upd_worst[kind], "dtype": "float32",
            "shape": "%d LM parameters, %d elements" % (t["parameters"],
                                                        t["elements"]),
            "ms": t["device_lr_ms"], "plain_ms": t["plain_ms"],
            "scalar_entry_ms": t["ms"],
            "main_path_entry": kind + "_lr (lr / wd read on the card)",
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "library_note": t["library_note"]})
    # the resnet phase's type heads the row
    t = wgrad_step[RESNET["dtype"]]
    rows.append({
        "name": "conv_wgrad", "route": "cuda", "source": WGRAD_SRC,
        "replaces": WGRAD_REPLACES,
        "launches": resnet["conv_wgrad_partial"]
        + resnet["conv_wgrad_reduce"] + resnet["conv_wgrad_repack"],
        "launches_by_kernel": {"partial": resnet["conv_wgrad_partial"],
                               "reduce": resnet["conv_wgrad_reduce"],
                               "repack": resnet["conv_wgrad_repack"]},
        "max_abs_err": max(wgrad_worst.values()), "max_err": wgrad_worst,
        "dtype": RESNET["dtype"],
        "shape": "the 16 3x3 convolutions of one ResNet-50 step at batch 32",
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": ("operations" if all(
            x["bound_by"] == "operations"
            for x in wgrad_timings[RESNET["dtype"]]) else "bytes"),
        "library_ms": t["library_ms"],
        "device_ms": t["device_ms"],
        "library_device_ms": t["library_device_ms"],
        "library": "torch.nn.grad.conv2d_weight (cuDNN wgrad, no TF32)",
        "float32": wgrad_step["float32"],
        "per_shape": wgrad_timings})
    t = lstm_timings["float32"]
    rows.append({
        "name": "lstm_step", "route": "cuda", "source": LSTM_SRC,
        "replaces": LSTM_REPLACES,
        "launches": lstm["fit"] + lstm["score"] + bucketing["lstm_step"]
        + bucketing["capture_lstm_step"],
        "launches_by_phase": {"lstm_fit": lstm["fit"],
                              "lstm_score": lstm["score"],
                              "bucketing": bucketing["lstm_step"],
                              "bucketing_capture":
                                  bucketing["capture_lstm_step"]},
        "max_abs_err": max(lstm_worst.values()), "max_err": lstm_worst,
        "dtype": "float32", "shape": "one step at (N, H) = (128, 512)",
        "kernel": t["kernel"], "layout": t["layout"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "library": "torch.mm(h, wh.t()) + aten._thnn_fused_lstm_cell (no "
                   "single PyTorch call computes the step)",
        "bfloat16": lstm_timings["bfloat16"],
        "bucketing_float32": lstm_timings["bucketing_float32"],
        "layer": lstm_layer})
    for kind in ("fwd", "bwd"):
        t = rtc_timings[kind]
        rows.append(dict(t, **{
            "name": "rtc_softmax_" + kind, "route": "cuda",
            "source": RTC_SRC, "replaces": RTC_REPLACES,
            "compiler": "NVRTC at run time (mxnet_tpu_torch/rtc.py, "
                        "ops/kernels/rtc_driver.py)",
            "launches": custom["fit"][kind] + custom["score"][kind],
            "launches_by_phase": {"custom_fit": custom["fit"][kind],
                                  "custom_score": custom["score"][kind]},
            "max_abs_err": rtc_worst, "dtype": "float32"}))
    emit({"kernels": rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
