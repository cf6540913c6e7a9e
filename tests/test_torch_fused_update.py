"""mxnet_tpu_torch fused updates against the Pallas kernels.

The plain versions (what the wrappers run for CPU tensors, and what the
CUDA kernels are held against on the card) are compared with
``mxnet_tpu/ops/pallas/fused_update.py`` in interpret mode on the same
numpy inputs. Both sides compute in f32 in the same order, so the
tolerance is rtol 1e-6 / atol 1e-7 (a last-bit difference of f32).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas import fused_update as jfu
from mxnet_tpu_torch import ndarray as nd
from mxnet_tpu_torch.ops.kernels import _build
from mxnet_tpu_torch.ops.kernels import fused_update as tfu

TOL = {"rtol": 1e-6, "atol": 1e-7}
# (rescale_grad, clip_gradient, wd): off, rescale only, clip + rescale + wd
HYPER = {"plain": (1.0, -1.0, 0.0), "rescale": (0.25, -1.0, 0.0),
         "clip_wd": (0.5, 0.05, 1e-3)}


def _buffers(n_state, shape=(37, 19), seed=0):
    rng = np.random.RandomState(seed)
    bufs = [rng.randn(*shape).astype(np.float32) for _ in range(2 + n_state)]
    if n_state == 2:
        bufs[3] = np.abs(bufs[3])  # Adam's var is a mean of squares
    return bufs


@pytest.mark.parametrize("case", sorted(HYPER))
def test_sgd_mom_plain_matches_pallas_interpret(case):
    rescale, clip, wd = HYPER[case]
    w, g, m = _buffers(1)
    want = jfu.sgd_mom_update(jnp.asarray(w), jnp.asarray(g), jnp.asarray(m),
                              lr=0.05, momentum=0.9, wd=wd,
                              rescale_grad=rescale, clip_gradient=clip,
                              interpret=True)
    tw, tg, tm = (torch.from_numpy(a.copy()) for a in (w, g, m))
    out = tfu.sgd_mom_update_plain(tw, tg, tm, 0.05, 0.9, wd, rescale, clip)
    assert out[0] is tw and out[1] is tm  # in place
    for got, ref in zip((tw, tm), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("case", sorted(HYPER))
def test_adam_plain_matches_pallas_interpret(case):
    rescale, clip, wd = HYPER[case]
    w, g, mean, var = _buffers(2, seed=1)
    want = jfu.adam_update(jnp.asarray(w), jnp.asarray(g), jnp.asarray(mean),
                           jnp.asarray(var), lr=1e-3, beta1=0.9, beta2=0.999,
                           epsilon=1e-8, wd=wd, rescale_grad=rescale,
                           clip_gradient=clip, interpret=True)
    tb = [torch.from_numpy(a.copy()) for a in (w, g, mean, var)]
    out = tfu.adam_update_plain(*tb, 1e-3, 0.9, 0.999, 1e-8, wd, rescale,
                                clip)
    assert out[0] is tb[0] and out[2] is tb[3]
    for got, ref in zip((tb[0], tb[2], tb[3]), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_bf16_buffers_update_in_f32_and_round_once():
    """bf16 weight/state: the math runs in f32 and each buffer is rounded
    once, as the Pallas kernel's astype — so the result equals the f32
    update of the widened buffers, rounded to bf16."""
    w, g, m = (torch.from_numpy(a).bfloat16() for a in _buffers(1, seed=2))
    w32, g32, m32 = (t.float() for t in (w, g, m))
    tfu.sgd_mom_update_plain(w, g, m, 0.05, 0.9, 1e-4, 1.0, -1.0)
    tfu.sgd_mom_update_plain(w32, g32, m32, 0.05, 0.9, 1e-4, 1.0, -1.0)
    assert w.dtype == torch.bfloat16
    assert torch.equal(w, w32.bfloat16()) and torch.equal(m, m32.bfloat16())


@pytest.mark.parametrize("kind", ["sgd_mom_update", "adam_update"])
def test_wrapper_on_cpu_takes_plain_and_counts_no_launch(kind):
    n_state = 1 if kind == "sgd_mom_update" else 2
    bufs = [torch.from_numpy(a) for a in _buffers(n_state, seed=3)]
    ref = [t.clone() for t in bufs]
    wrapper = getattr(tfu, kind)
    plain = getattr(tfu, kind + "_plain")
    before = wrapper.launches
    wrapper(*bufs, 0.01)
    plain(*ref, 0.01)
    assert wrapper.launches == before
    for a, b in zip(bufs, ref):
        assert torch.equal(a, b)


def test_wrapper_rejects_what_no_path_takes():
    w, g, m = (torch.from_numpy(a) for a in _buffers(1))
    with pytest.raises(ValueError, match="must match"):
        tfu.sgd_mom_update(w, g[:3], m, 0.01)
    with pytest.raises(ValueError, match="must match"):
        tfu.sgd_mom_update(w, g.double(), m, 0.01)
    with pytest.raises(ValueError, match="no path"):
        tfu.sgd_mom_update(w.to("meta"), g.to("meta"), m.to("meta"), 0.01)
    # what a CUDA tensor must satisfy before the kernel launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfu._check_kernel("sgd_mom_update", [w.half(), g.half(), m.half()])
    with pytest.raises(ValueError, match="contiguous"):
        tfu._check_kernel("sgd_mom_update", [w.t(), g.t(), m.t()])


def test_registry_ops_update_in_place_through_nd():
    """``nd.sgd_mom_update`` / ``nd.adam_update`` hand back the very
    buffers they were given, updated (the reference returns new arrays)."""
    w, g, m = (nd.array(a, ctx="cpu") for a in _buffers(1, seed=4))
    w_data, m_data = w._data, m._data
    before = w.asnumpy().copy()
    new_w, new_m = nd.sgd_mom_update(w, g, m, lr=0.1, momentum=0.9)
    assert new_w._data is w_data and new_m._data is m_data
    assert not np.array_equal(w.asnumpy(), before)
    out = nd.sgd_update(w, g, out=w, lr=0.1)
    assert out is w and w._data is w_data


def test_update_kernel_source_is_built_by_name():
    assert "fused_update" in _build.sources()
    assert _build.lib_path("fused_update").endswith(".so")
