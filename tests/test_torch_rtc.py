"""mxnet_tpu_torch.rtc against the JAX package's mx.rtc, on the CPU.

The CUDA kernels compile and run only on the card (``chip_smoke.py``'s
``kernel_rtc`` phase holds each against its twin there). Here:

- the ``mode="torch"`` twins of the JAX tests' kernels against the JAX
  package's ``Rtc``: axpy and inc in pallas mode (interpret on the CPU, as
  its own tests run it), relu in jax mode; exact (the same f32 arithmetic);
- the source cache, and every error the port raises before any kernel
  runs: a bad torch source, the JAX package's modes, wrong input / output
  counts, missing or malformed launch dimensions, a cuda-mode push of CPU
  tensors;
- the generated CUDA signature for every supported type (a pure function);
- the ``rtc_softmax`` twins against the JAX package's ``softmax`` and
  ``SoftmaxOutput`` gradient on the same logits and labels, within rtol
  1e-5 / atol 1e-6 (f32, sums in other orders), and the kernels' launch
  shapes.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.tools import rtc_softmax as rs

TOL = {"rtol": 1e-5, "atol": 1e-6}

# name -> (inputs, JAX package source, its mode, port twin source)
KERNELS = {
    "axpy": (["x", "y"], """
    def kernel(x_ref, y_ref, out_ref):
        out_ref[...] = x_ref[...] * 2.0 + y_ref[...]
    """, "pallas", """
    def fn(x, y):
        return x * 2.0 + y
    """),
    "inc": (["x"], """
    def kernel(x_ref, out_ref):
        out_ref[...] = x_ref[...] + 1.0
    """, "pallas", """
    def fn(x):
        return x + 1.0
    """),
    "relu": (["x"], """
    def fn(x):
        return jnp.maximum(x, 0.0)
    """, "jax", """
    def fn(x):
        return torch.clamp(x, min=0.0)
    """),
}


def _push(pkg, name, src, mode, arrays, ctx):
    ins = [pkg.nd.array(a, ctx=ctx) for a in arrays]
    out = pkg.nd.zeros(arrays[0].shape, ctx=ctx)
    names = KERNELS[name][0]
    pkg.rtc.create(name, names, ["out"], src, mode=mode).push(ins, [out])
    return out.asnumpy()


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_torch_twin_matches_the_jax_rtc(name):
    names, jax_src, jax_mode, twin_src = KERNELS[name]
    rng = np.random.RandomState(len(name))
    arrays = [rng.randn(8, 16).astype(np.float32) for _ in names]
    got = _push(mt, name, twin_src, "torch", arrays, "cpu")
    want = _push(mx, name, jax_src, jax_mode, arrays, None)
    np.testing.assert_array_equal(got, want)


def test_create_caches_by_name_mode_and_source():
    src = KERNELS["inc"][3]
    a = mt.rtc.create("inc", ["x"], ["out"], src, mode="torch")
    assert mt.rtc.create("inc", ["x"], ["out"], src, mode="torch") is a
    assert mt.rtc.create("inc", ["x"], ["out"], src + "\n",
                         mode="torch") is not a
    body = "out[0] = x[0];"
    k = mt.rtc.create("inc", ["x"], ["out"], body)
    assert k.mode == "cuda" and k is mt.rtc.create("inc", ["x"], ["out"],
                                                   body)
    assert k.launches == 0 and k.compile_ms == {}


@pytest.mark.parametrize("src,match", [
    ("def fn(x):\n    return x +\n", "failed to compile"),
    ("def not_fn(x):\n    return x\n", "named 'fn'"),
])
def test_bad_torch_source_raises(src, match):
    with pytest.raises(MXNetError, match=match):
        mt.rtc.Rtc("bad", ["x"], ["o"], src, mode="torch")


@pytest.mark.parametrize("mode", ["pallas", "jax"])
def test_the_jax_packages_modes_raise_naming_the_ports(mode):
    with pytest.raises(MXNetError, match="'cuda'.*'torch'|cuda.*torch"):
        mt.rtc.create("k", ["x"], ["o"], "def fn(x): return x", mode=mode)
    with pytest.raises(MXNetError, match="mode"):
        mt.rtc.Rtc("k", ["x"], ["o"], "", mode="opencl")


def test_wrong_counts_raise_in_both_modes():
    x = mt.nd.zeros((2,), ctx="cpu")
    twin = mt.rtc.create("inc", ["x"], ["out"], KERNELS["inc"][3],
                         mode="torch")
    kern = mt.rtc.create("inc", ["x"], ["out"], "out[0] = x[0];")
    for k in (twin, kern):
        with pytest.raises(MXNetError, match="expects 1 inputs, got 2"):
            k.push([x, x], [x], grid_dims=(1,), block_dims=(1,))
        with pytest.raises(MXNetError, match="expects 1 outputs, got 0"):
            k.push([x], [], grid_dims=(1,), block_dims=(1,))
    with pytest.raises(MXNetError, match="fn returned 1 outputs, want 2"):
        mt.rtc.create("two", ["x"], ["a", "b"], KERNELS["inc"][3],
                      mode="torch").push([x], [x, x])


@pytest.mark.parametrize("grid,block,match", [
    (None, (1,), "needs grid_dims"),
    ((1,), None, "needs block_dims"),
    ((1, 1, 1, 1), (1,), "1 to 3"),
    ((0,), (1,), "positive"),
    ((1,), (2.5,), "positive"),
])
def test_cuda_push_needs_launch_dimensions(grid, block, match):
    x = mt.nd.zeros((2,), ctx="cpu")
    kern = mt.rtc.create("inc", ["x"], ["out"], "out[0] = x[0];")
    with pytest.raises(MXNetError, match=match):
        kern.push([x], [x], grid_dims=grid, block_dims=block)


def test_cuda_push_of_cpu_tensors_raises_and_never_falls_back():
    x = mt.nd.array(np.ones(4, np.float32), ctx="cpu")
    out = mt.nd.zeros((4,), ctx="cpu")
    kern = mt.rtc.create("inc", ["x"], ["out"], "out[0] = x[0] + 1.0f;")
    with pytest.raises(MXNetError, match="runs CUDA kernels"):
        kern.push([x], [out], grid_dims=(1,), block_dims=(4,))
    np.testing.assert_array_equal(out.asnumpy(), np.zeros(4))
    assert kern.launches == 0


@pytest.mark.parametrize("dtype,ctype", [
    (torch.float32, "float"), (torch.float64, "double"),
    (torch.bfloat16, "__nv_bfloat16"), (torch.int32, "int"),
    (torch.int64, "long long")])
def test_generated_signature_for_each_type(dtype, ctype):
    k = mt.rtc.Rtc("axpy", ["x", "y"], ["out"], "  out[0] = x[0];")
    src = k.source([dtype, torch.float32], [dtype])
    sig = ('extern "C" __global__ void axpy(const %s* x, const float* y, '
           '%s* out) {' % (ctype, ctype))
    assert sig in src
    assert src.endswith(") {\nout[0] = x[0];\n}\n")  # body dedented
    assert ("#include <cuda_bf16.h>" in src) == (dtype == torch.bfloat16)


def test_unsupported_types_and_names_raise():
    k = mt.rtc.Rtc("k", ["x"], ["o"], "o[0] = x[0];")
    with pytest.raises(MXNetError, match="no CUDA type"):
        k.source([torch.complex64], [torch.float32])
    with pytest.raises(MXNetError, match="C identifier"):
        mt.rtc.Rtc("k", ["x-1"], ["o"], "")


# --- rtc_softmax ----------------------------------------------------------------
def _jax_softmax_head(logits, label):
    data = mx.sym.Variable("data")
    lab = mx.sym.Variable("label")
    head = mx.sym.SoftmaxOutput(data=data, label=lab, name="softmax")
    exe = head.simple_bind(mx.cpu(), data=logits.shape, label=label.shape,
                           grad_req={"data": "write", "label": "null"})
    exe.arg_dict["data"][:] = logits
    exe.arg_dict["label"][:] = label
    prob = exe.forward(is_train=True)[0].asnumpy()
    exe.backward()
    return prob, exe.grad_dict["data"].asnumpy()


@pytest.mark.parametrize("rows,cols", [(3, 7), (5, 50), (2, 1000)])
def test_rtc_softmax_twins_match_jax_softmax_output(rows, cols):
    rng = np.random.RandomState(rows)
    logits = (3 * rng.randn(rows, cols)).astype(np.float32)
    label = rng.randint(0, cols, rows).astype(np.float32)
    x = mt.nd.array(logits, ctx="cpu")
    lab = mt.nd.array(label, ctx="cpu")
    prob, grad = (mt.nd.zeros((rows, cols), ctx="cpu") for _ in range(2))
    rs.push("fwd", [x], [prob])
    rs.push("bwd", [prob, lab], [grad])
    want_prob, want_grad = _jax_softmax_head(logits, label)
    np.testing.assert_allclose(prob.asnumpy(), want_prob, **TOL)
    np.testing.assert_allclose(grad.asnumpy(), want_grad, **TOL)


@pytest.mark.parametrize("cols,block,per", [
    (7, 32, 1), (1000, 128, 8), (4096, 512, 8), (10000, 512, 20),
    (32768, 512, 64)])
def test_rtc_softmax_launch_shape(cols, block, per):
    assert rs.launch_dims(cols) == (block, per)
    src = rs.kernels(cols)["fwd"].src
    assert "COLS = %d, BLOCK = %d, PER = %d;" % (cols, block, per) in src


def test_rtc_softmax_refuses_rows_too_wide_for_registers():
    with pytest.raises(MXNetError, match="at most 32768 columns"):
        rs.launch_dims(32769)
