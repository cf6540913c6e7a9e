"""A softmax loss head written as a Custom op whose forward and backward are
CUDA kernels compiled at run time through ``mx.rtc``.

The workload of the port's user-extension slice: the LSTM LM of
:mod:`mxnet_tpu_torch.tools.lstm_lm` with its ``SoftmaxOutput`` head
replaced by ``sym.Custom(op_type="rtc_softmax")`` (:func:`lstm_rtc_symbol`),
trained through ``Module.fit``. ``chip_smoke.py`` (its ``kernel_rtc`` and
``custom`` phases) and the CPU tests take the op and the symbol from here.

The two kernels replace what the JAX package runs for such a head: user
Pallas kernels compiled at run time through ``mxnet_tpu/rtc.py:86``
(``Rtc._get_compiled``), and the host-numpy Custom head of
``examples/numpy-ops/custom_softmax.py`` (there the logits leave the
device through ``pure_callback``; here they never leave the card).

- **forward** (:data:`FWD_SRC`): a row softmax, one block per row. Each
  thread keeps its ``ceil(cols / block)`` strided elements of the row in
  registers, so the row is read once and written once; the row max and the
  sum of exp(x - max) reduce by warp shuffles, then across the block's
  warps through shared memory; y = exp(x - max) / sum.
- **backward**: p - onehot(label), the label read as f32 ids, one block
  per row: what ``SoftmaxOutput`` computes at the LSTM LM's attributes
  (grad_scale 1, normalization null, no ignore label). The head gradient
  is ignored (``need_top_grad=False``). Two sources, picked by
  :func:`bwd_plan`: :data:`BWD_VEC_SRC` for rows of ``cols % 4 == 0``
  columns with p and the gradient on 16-byte boundaries (each thread
  issues all its ``PER4`` streaming float4 loads, fully unrolled at a
  constant ``BLOCK``, before any store; the label is read once a row and
  broadcast through shared memory), and :data:`BWD_SRC` for any other
  row (scalar, strided by the block).

Both are bound by bytes: at the LM's (4480, 10000) f32 each reads 179.2 MB
and writes 179.2 MB (the backward's 17.9 KB of labels aside), 358.4 MB over
the H100's 3.35 TB/s = 0.107 ms. Their plain versions (:data:`FWD_TWIN`,
:data:`BWD_TWIN`) are ``mode="torch"`` Rtc sources; the op runs them only
for CPU tensors. The column count and the block size are constants of the
kernel source (as MXRtc's users formatted them in), so each vocabulary
size compiles once.
"""
from __future__ import annotations

import collections
import math

from .. import operator, rtc
from ..base import MXNetError

#: a row lives in registers: at most this many columns per thread
MAX_PER_THREAD = 64
#: threads per block: up to 16 warps, so a thread holds <= 20 of a 10000-row
MAX_WARPS = 16

FWD_SRC = """
const int COLS = %(cols)d, BLOCK = %(block)d, PER = %(per)d;
__shared__ float red[BLOCK / 32];
const long long base = (long long)blockIdx.x * COLS;
const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
const float NEG_INF = __int_as_float(0xff800000);
float v[PER];
float m = NEG_INF;
#pragma unroll
for (int k = 0; k < PER; ++k) {
  const int c = tid + k * BLOCK;
  v[k] = c < COLS ? x[base + c] : NEG_INF;
  m = fmaxf(m, v[k]);
}
#pragma unroll
for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
if (lane == 0) red[warp] = m;
__syncthreads();
m = red[0];
for (int w = 1; w < BLOCK / 32; ++w) m = fmaxf(m, red[w]);
__syncthreads();
float s = 0.0f;
#pragma unroll
for (int k = 0; k < PER; ++k) {
  const int c = tid + k * BLOCK;
  v[k] = c < COLS ? expf(v[k] - m) : 0.0f;
  s += v[k];
}
#pragma unroll
for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
if (lane == 0) red[warp] = s;
__syncthreads();
s = 0.0f;
for (int w = 0; w < BLOCK / 32; ++w) s += red[w];
#pragma unroll
for (int k = 0; k < PER; ++k) {
  const int c = tid + k * BLOCK;
  if (c < COLS) y[base + c] = v[k] / s;
}
"""

BWD_VEC_SRC = """
const int COLS = %(cols)d, BLOCK = %(block)d, PER4 = %(per4)d;
const int C4 = COLS / 4;
__shared__ int lab_s;
const long long base = (long long)blockIdx.x * C4;
const float4* p4 = reinterpret_cast<const float4*>(prob) + base;
float4* g4 = reinterpret_cast<float4*>(grad) + base;
const int tid = threadIdx.x;
float4 v[PER4];
#pragma unroll
for (int k = 0; k < PER4; ++k) {
  const int q = tid + k * BLOCK;
  if (q < C4)
    asm volatile("ld.global.cs.v4.f32 {%%0, %%1, %%2, %%3}, [%%4];"
                 : "=f"(v[k].x), "=f"(v[k].y), "=f"(v[k].z), "=f"(v[k].w)
                 : "l"(p4 + q));
}
if (tid == 0) lab_s = (int)label[blockIdx.x];
__syncthreads();
const int lab = lab_s;
#pragma unroll
for (int k = 0; k < PER4; ++k) {
  const int q = tid + k * BLOCK;
  if (q < C4) {
    float4 g = v[k];
    if (q == (lab >> 2)) {
      const int e = lab & 3;
      if (e == 0) g.x -= 1.0f;
      else if (e == 1) g.y -= 1.0f;
      else if (e == 2) g.z -= 1.0f;
      else g.w -= 1.0f;
    }
    asm volatile("st.global.cs.v4.f32 [%%0], {%%1, %%2, %%3, %%4};"
                 :: "l"(g4 + q), "f"(g.x), "f"(g.y), "f"(g.z), "f"(g.w)
                 : "memory");
  }
}
"""

BWD_SRC = """
const int COLS = %(cols)d;
const long long base = (long long)blockIdx.x * COLS;
const int lab = (int)label[blockIdx.x];
for (int c = threadIdx.x; c < COLS; c += blockDim.x)
  grad[base + c] = prob[base + c] - (c == lab ? 1.0f : 0.0f);
"""

FWD_TWIN = """
def fn(x):
    e = torch.exp(x - x.max(dim=1, keepdim=True).values)
    return e / e.sum(dim=1, keepdim=True)
"""

BWD_TWIN = """
def fn(prob, label):
    grad = prob.clone()
    rows = torch.arange(prob.shape[0], device=prob.device)
    grad[rows, label.long()] -= 1.0
    return grad
"""


def launch_dims(cols):
    """(threads per block, columns per thread) of both kernels at
    ``cols`` columns: enough warps to keep each thread's share of the row
    at 8 or fewer, at most :data:`MAX_WARPS` warps."""
    warps = min(MAX_WARPS, max(1, math.ceil(cols / (32 * 8))))
    block = 32 * warps
    per = math.ceil(cols / block)
    if per > MAX_PER_THREAD:
        raise MXNetError("rtc_softmax keeps a row in registers: at most %d "
                         "columns, got %d" % (MAX_PER_THREAD * block, cols))
    return block, per


def bwd_launch_dims(cols):
    """(threads per block, float4 per thread) of the vector backward
    (:data:`BWD_VEC_SRC`) at ``cols`` columns, a multiple of 4: enough
    warps to keep each thread's share of the row at 8 float4 or fewer, at
    most :data:`MAX_WARPS` warps."""
    if cols % 4:
        raise MXNetError("rtc_softmax's vector backward takes rows of a "
                         "multiple of 4 columns, got %d" % cols)
    c4 = cols // 4
    warps = min(MAX_WARPS, max(1, math.ceil(c4 / (32 * 8))))
    block = 32 * warps
    per4 = math.ceil(c4 / block)
    if 4 * per4 > MAX_PER_THREAD:
        raise MXNetError("rtc_softmax keeps a row in registers: at most %d "
                         "columns, got %d" % (MAX_PER_THREAD * block, cols))
    return block, per4


BwdPlan = collections.namedtuple("BwdPlan", "route kernel block per")
BwdPlan.__doc__ = """How the backward runs on a CUDA row set: ``route``
"vector" (:data:`BWD_VEC_SRC`, ``per`` float4 a thread) or "scalar"
(:data:`BWD_SRC`, ``per`` floats a thread); ``kernel`` the key of
:func:`kernels`; ``block`` threads a block (one block a row)."""


def bwd_plan(cols, prob_ptr, grad_ptr):
    """The :class:`BwdPlan` of the backward at ``cols`` columns with p and
    the gradient at data pointers ``prob_ptr`` / ``grad_ptr``: the vector
    source where every row starts on 16 bytes, else the scalar one."""
    if cols % 4 == 0 and prob_ptr % 16 == 0 and grad_ptr % 16 == 0:
        return BwdPlan("vector", "bwd_vec", *bwd_launch_dims(cols))
    return BwdPlan("scalar", "bwd", *launch_dims(cols))


def kernels(cols):
    """{"fwd", "bwd"} and, for ``cols % 4 == 0``, "bwd_vec": the CUDA Rtc
    kernels for rows of ``cols`` columns (cached by source, so one per
    vocabulary size)."""
    block, per = launch_dims(cols)
    spec = {"cols": cols, "block": block, "per": per}
    out = {"fwd": rtc.create("rtc_softmax_fwd", ["x"], ["y"],
                             FWD_SRC % spec),
           "bwd": rtc.create("rtc_softmax_bwd", ["prob", "label"],
                             ["grad"], BWD_SRC % spec)}
    if cols % 4 == 0:
        block4, per4 = bwd_launch_dims(cols)
        out["bwd_vec"] = rtc.create(
            "rtc_softmax_bwd_vec", ["prob", "label"], ["grad"],
            BWD_VEC_SRC % {"cols": cols, "block": block4, "per4": per4})
    return out


def twins():
    """{"fwd", "bwd"}: the kernels' plain versions (``mode="torch"``)."""
    return {"fwd": rtc.create("rtc_softmax_fwd", ["x"], ["y"], FWD_TWIN,
                              mode="torch"),
            "bwd": rtc.create("rtc_softmax_bwd", ["prob", "label"],
                              ["grad"], BWD_TWIN, mode="torch")}


def push(kind, ins, outs):
    """Run the ``kind`` ("fwd" / "bwd") kernel on NDArrays: the CUDA
    kernel, one block per row, for CUDA tensors (the backward's source by
    :func:`bwd_plan`); the plain version for CPU tensors."""
    rows, cols = ins[0].shape
    if ins[0].context.type == "cpu":
        return twins()[kind].push(ins, outs)
    if kind == "bwd":
        p = bwd_plan(cols, ins[0]._data.data_ptr(),
                     outs[0]._data.data_ptr())
        kind, block = p.kernel, p.block
    else:
        block, _ = launch_dims(cols)
    return kernels(cols)[kind].push(ins, outs, grid_dims=(rows,),
                                    block_dims=(block,))


class RtcSoftmax(operator.CustomOp):
    """Softmax forward, p - onehot(label) backward, each one rtc kernel."""

    def forward(self, is_train, req, in_data, out_data, aux):
        self._run("fwd", req[0], [in_data[0]], out_data[0])

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        del out_grad  # need_top_grad=False: the head gradient is ignored
        self._run("bwd", req[0], [out_data[0], in_data[1]], in_grad[0])
        self.assign(in_grad[1], req[1], 0)

    @staticmethod
    def _run(kind, req, ins, dst):
        """The kernel straight into ``dst`` (req "write" or "inplace"; the
        op's graph never asks this head for "add")."""
        if req == "null":
            return
        if req not in ("write", "inplace"):
            raise MXNetError("rtc_softmax writes its result: req %r" % req)
        push(kind, ins, [dst])


@operator.register("rtc_softmax")
class RtcSoftmaxProp(operator.CustomOpProp):
    """``data`` (rows, classes) f32 and ``label`` (rows,) f32 class ids ->
    the softmax over each row; a loss head (``need_top_grad=False``)."""

    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        data = in_shape[0]
        return [data, [data[0]]], [data], []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        """The backward reads the probabilities and the label only: the
        logits are not kept for it."""
        return [out_data[0], in_data[1]]

    def create_operator(self, ctx, shapes, dtypes):
        if len(shapes[0]) != 2 or str(dtypes[0]) != "float32":
            raise MXNetError("rtc_softmax takes 2-D float32 data, got %s %s"
                             % (shapes[0], dtypes[0]))
        launch_dims(shapes[0][1])  # refuses a row too wide for registers
        return RtcSoftmax()


def lstm_rtc_symbol(cfg):
    """:func:`~.lstm_lm.lstm_symbol` with its ``SoftmaxOutput`` head
    replaced by ``Custom(op_type="rtc_softmax", name="softmax")`` over the
    same ``pred`` logits and the same reshaped label: the same arguments,
    output name and weights."""
    from .. import symbol as sym
    from .lstm_lm import lstm_symbol

    head = lstm_symbol(cfg)
    pred = head.get_internals()["pred_output"]
    label = sym.Symbol([head._entries[0][0].inputs[1]])
    return sym.Custom(data=pred, label=label, op_type="rtc_softmax",
                      name="softmax")
