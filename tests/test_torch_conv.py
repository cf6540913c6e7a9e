"""mxnet_tpu_torch convolution-path ops against the JAX package, on the CPU.

- ``conv_wgrad_plain`` (what the wrapper runs for CPU tensors, and what the
  CUDA kernel is held against on the card) against
  ``mxnet_tpu/ops/pallas/conv_bwd.py``'s ``conv_wgrad`` in interpret mode,
  on the same bf16-rounded numpy inputs: the oracle's cases
  (``tests/test_consistency.py:370-374``) and ResNet's C = K = 64 stride-2
  case. Both widen the bf16 operands exactly and sum in f32 in other
  orders: tolerance 1e-5 of max |dW|.
- ``Convolution``, ``Pooling`` and ``BatchNorm``: forward, every input
  gradient (``jax.vjp`` against ``torch.autograd.grad`` for one numpy
  cotangent) and BatchNorm's aux updates. f32 both sides, other summation
  orders: rtol 1e-5 / atol 1e-5.
- The Convolution op's weight gradient goes through ``conv_wgrad`` for 3x3
  windows (and only for those) and equals torch autograd's.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops.pallas import conv_bwd as jconv
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops.kernels import conv_wgrad as cw

TOL = {"rtol": 1e-5, "atol": 1e-5}
WGRAD_TOL = 1e-5


@pytest.mark.parametrize("n,h,c,k,ksz,stride", [
    (2, 8, 8, 16, 3, 1), (2, 9, 8, 16, 3, 1), (2, 8, 8, 16, 3, 2),
    (1, 5, 4, 8, 1, 1), (4, 7, 16, 32, 3, 1), (2, 8, 64, 64, 3, 2)])
def test_conv_wgrad_plain_matches_pallas_interpret(n, h, c, k, ksz, stride):
    rng = np.random.RandomState(n * h + c)
    pad = (ksz - 1) // 2
    oh = cw.out_size(h, ksz, stride, pad)
    # rounded to bf16 first: the Pallas kernel casts its operands
    x = torch.randn(n, h, h, c, generator=torch.Generator().manual_seed(
        int(rng.randint(1 << 30)))).to(torch.bfloat16)
    dy = torch.randn(n, oh, oh, k, generator=torch.Generator().manual_seed(
        int(rng.randint(1 << 30)))).to(torch.bfloat16)
    xf, dyf = x.float().numpy(), dy.float().numpy()
    want = np.asarray(jconv.conv_wgrad(jnp.asarray(xf), jnp.asarray(dyf),
                                       ksz, stride, interpret=True))
    got = cw.conv_wgrad_plain(x, dy, ksz, stride)
    assert got.dtype == torch.float32 and got.shape == (ksz, ksz, c, k)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=WGRAD_TOL * scale)
    # the public wrapper casts to bf16 as the reference does
    pub = cw.conv_wgrad(torch.from_numpy(xf), torch.from_numpy(dyf), ksz,
                        stride)
    np.testing.assert_array_equal(pub.numpy(), got.numpy())


def test_conv_wgrad_checks_shapes_and_takes_strided_views():
    x = torch.randn(2, 5, 9, 9)                      # NCHW
    dy = torch.randn(2, 7, 5, 5)
    xv, dv = x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1)
    got = cw.wgrad(xv, dv, 3, 2, 1)
    want = cw.wgrad(xv.contiguous(), dv.contiguous(), 3, 2, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="does not match"):
        cw.wgrad(xv, dv, 3, 1, 1)
    with pytest.raises(TypeError):
        cw.wgrad(xv, dv.double(), 3, 2, 1)


@pytest.mark.parametrize("m,k,l", [(576, 64, 100352), (4608, 512, 1568),
                                   (9 * 4, 8, 10), (1152, 128, 25088)])
def test_splits_cover_the_reduction(m, k, l):
    splits, chunk = cw.splits_for(m, k, l)
    assert chunk % cw.TILE_L == 0 and splits * chunk >= l
    assert (splits - 1) * chunk < l          # no empty split
    assert 1 <= splits <= 65535


def _f(*shape):
    return lambda rng: rng.randn(*shape).astype(np.float32)


def _jax_run(op, arrays, aux, attrs, is_train, cot):
    jop = jreg.get_op(op)
    parsed = jop.parse_attrs(dict(attrs))
    auxv = tuple(jnp.asarray(a) for a in aux)

    def f(*xs):
        outs, _ = jop.impl(parsed, xs, auxv, jreg.OpContext(is_train, None))
        return outs[0]

    xs = [jnp.asarray(a) for a in arrays]
    outs, aux_up = jop.impl(parsed, tuple(xs), auxv,
                            jreg.OpContext(is_train, None))
    _, vjp = jax.vjp(f, *xs)
    grads = vjp(jnp.asarray(cot))
    return ([np.asarray(o) for o in outs], [np.asarray(g) for g in grads],
            [np.asarray(a) for a in aux_up])


def _torch_run(op, arrays, aux, attrs, is_train, cot):
    top = treg.get_op(op)
    parsed = top.parse_attrs(dict(attrs))
    xs = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    auxv = tuple(torch.from_numpy(a.copy()) for a in aux)
    outs, aux_up = top.impl(parsed, tuple(xs), auxv,
                            treg.OpContext(is_train))
    grads = torch.autograd.grad(outs[0], xs, torch.from_numpy(cot),
                                allow_unused=True)
    return ([o.detach().numpy() for o in outs],
            [np.zeros_like(a) if g is None else g.numpy()
             for a, g in zip(arrays, grads)],
            [a.detach().numpy() for a in aux_up])


def _compare(op, makers, attrs, aux=(), is_train=True, seed=0):
    rng = np.random.RandomState(seed)
    arrays = [m(rng) for m in makers]
    out_shape = jax.eval_shape(
        lambda *xs: jreg.get_op(op).impl(
            jreg.get_op(op).parse_attrs(dict(attrs)), xs,
            tuple(jnp.asarray(a) for a in aux),
            jreg.OpContext(is_train, None))[0][0],
        *[jnp.asarray(a) for a in arrays]).shape
    cot = rng.randn(*out_shape).astype(np.float32)
    want_out, want_grad, want_aux = _jax_run(op, arrays, aux, attrs,
                                             is_train, cot)
    got_out, got_grad, got_aux = _torch_run(op, arrays, aux, attrs,
                                            is_train, cot)
    assert len(got_out) == len(want_out)
    for i, (g, w) in enumerate(zip(got_out, want_out)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, err_msg="output %d" % i, **TOL)
    for i, (g, w) in enumerate(zip(got_grad, want_grad)):
        np.testing.assert_allclose(g, w, err_msg="grad of input %d" % i,
                                   **TOL)
    for i, (g, w) in enumerate(zip(got_aux, want_aux)):
        np.testing.assert_allclose(g, w, err_msg="aux %d" % i, **TOL)


# name -> (input makers, attrs); inputs data, weight[, bias]
CONV = {
    "3x3_s1": ([_f(2, 4, 9, 9), _f(6, 4, 3, 3)],
               {"kernel": (3, 3), "num_filter": 6, "pad": (1, 1),
                "no_bias": True}),
    "3x3_s2_bias": ([_f(2, 4, 9, 9), _f(6, 4, 3, 3), _f(6)],
                    {"kernel": (3, 3), "num_filter": 6, "pad": (1, 1),
                     "stride": (2, 2)}),
    "1x1": ([_f(2, 8, 5, 5), _f(4, 8, 1, 1)],
            {"kernel": (1, 1), "num_filter": 4, "no_bias": True}),
    "7x7_s2": ([_f(2, 3, 16, 16), _f(8, 3, 7, 7)],
               {"kernel": (7, 7), "num_filter": 8, "stride": (2, 2),
                "pad": (3, 3), "no_bias": True}),
    "grouped": ([_f(2, 4, 7, 7), _f(6, 2, 3, 3), _f(6)],
                {"kernel": (3, 3), "num_filter": 6, "num_group": 2,
                 "pad": (1, 1)}),
    "5x5_bias": ([_f(2, 1, 12, 12), _f(5, 1, 5, 5), _f(5)],
                 {"kernel": (5, 5), "num_filter": 5}),
}


@pytest.mark.parametrize("case", sorted(CONV))
def test_convolution_matches_jax(case):
    makers, attrs = CONV[case]
    _compare("Convolution", makers, attrs, seed=len(case))


POOL = {
    "max_pad": ([_f(2, 3, 9, 9)], {"kernel": (3, 3), "stride": (2, 2),
                                   "pad": (1, 1), "pool_type": "max"}),
    "avg": ([_f(2, 3, 8, 8)], {"kernel": (2, 2), "stride": (2, 2),
                               "pool_type": "avg"}),
    "avg_pad": ([_f(2, 3, 7, 7)], {"kernel": (3, 3), "stride": (2, 2),
                                   "pad": (1, 1), "pool_type": "avg"}),
    "sum": ([_f(2, 3, 6, 6)], {"kernel": (3, 3), "stride": (1, 1),
                               "pool_type": "sum"}),
    "global_avg": ([_f(2, 3, 5, 5)], {"kernel": (7, 7), "global_pool": True,
                                      "pool_type": "avg"}),
    "global_max": ([_f(2, 3, 5, 5)], {"global_pool": True,
                                      "pool_type": "max"}),
    "full_odd": ([_f(2, 3, 7, 7)], {"kernel": (2, 2), "stride": (2, 2),
                                    "pool_type": "max",
                                    "pooling_convention": "full"}),
    "full_avg_odd": ([_f(1, 2, 9, 9)], {"kernel": (3, 3), "stride": (2, 2),
                                        "pool_type": "avg",
                                        "pooling_convention": "full"}),
}


@pytest.mark.parametrize("case", sorted(POOL))
def test_pooling_matches_jax(case):
    makers, attrs = POOL[case]
    _compare("Pooling", makers, attrs, seed=len(case))


def test_pooling_full_is_not_ceil_mode():
    """The reference's "full" adds a high-side pad: at 7 wide, kernel 2,
    stride 2 that gives 4 windows, the last one over column 6 alone."""
    top = treg.get_op("Pooling")
    attrs = top.parse_attrs({"kernel": (2, 2), "stride": (2, 2),
                             "pool_type": "avg",
                             "pooling_convention": "full"})
    x = torch.ones(1, 1, 7, 7)
    (out,), _ = top.impl(attrs, (x,), (), treg.OpContext(False))
    assert out.shape == (1, 1, 4, 4)
    # avg divides by the whole window, padding included
    assert float(out[0, 0, 3, 3]) == 0.25 and float(out[0, 0, 0, 0]) == 1.0


def _bn_inputs(c):
    return [_f(2, c, 5, 5), lambda rng: (1 + 0.1 * rng.randn(c)).astype(
        np.float32), _f(c)]


BN = {
    "train": ({"eps": 2e-5, "fix_gamma": False}, True),
    "train_fix_gamma": ({"eps": 1e-3, "fix_gamma": True}, True),
    "eval": ({"eps": 2e-5, "fix_gamma": False}, False),
    "global_stats": ({"fix_gamma": False, "use_global_stats": True}, True),
    "momentum": ({"fix_gamma": False, "momentum": 0.7}, True),
}


@pytest.mark.parametrize("case", sorted(BN))
def test_batch_norm_matches_jax(case):
    attrs, is_train = BN[case]
    rng = np.random.RandomState(3)
    aux = (rng.randn(4).astype(np.float32),
           (rng.rand(4) + 0.5).astype(np.float32))
    _compare("BatchNorm", _bn_inputs(4), attrs, aux=aux, is_train=is_train,
             seed=len(case))


def test_batch_norm_biased_variance_and_mean_var_outputs():
    """The batch variance is biased (it goes into moving_var so), and
    output_mean_var returns it with the mean."""
    top = treg.get_op("BatchNorm")
    attrs = top.parse_attrs({"fix_gamma": True, "output_mean_var": True,
                             "momentum": 0.0})
    x = torch.randn(3, 2, 4, 4)
    outs, (mm, mv) = top.impl(attrs, (x, torch.ones(2), torch.zeros(2)),
                              (torch.zeros(2), torch.ones(2)),
                              treg.OpContext(True))
    want_var = x.var(dim=(0, 2, 3), unbiased=False)
    assert len(outs) == 3
    np.testing.assert_allclose(outs[2].detach().numpy(), want_var.numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(mv.numpy(), want_var.numpy(), rtol=1e-5)
    np.testing.assert_allclose(mm.numpy(), x.mean(dim=(0, 2, 3)).numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case,kernel_calls", [("3x3_s1", 1),
                                               ("3x3_s2_bias", 1),
                                               ("1x1", 0), ("7x7_s2", 0),
                                               ("grouped", 0)])
def test_convolution_weight_grad_routes_through_conv_wgrad(
        case, kernel_calls, monkeypatch):
    """3x3 windows take dW from conv_wgrad (its plain version here), and
    it equals torch autograd's; the data gradient is skipped when the data
    needs none."""
    calls = []
    plain = cw.conv_wgrad_plain

    def counted(*args, **kwargs):
        calls.append(args[2])
        return plain(*args, **kwargs)

    monkeypatch.setattr(cw, "conv_wgrad_plain", counted)
    makers, attrs = CONV[case]
    rng = np.random.RandomState(1)
    arrays = [torch.from_numpy(m(rng)) for m in makers]
    top = treg.get_op("Convolution")
    parsed = top.parse_attrs(dict(attrs))
    x = arrays[0]                                     # no gradient wanted
    params = [a.clone().requires_grad_() for a in arrays[1:]]
    (out,), _ = top.impl(parsed, (x, *params), (), treg.OpContext(True))
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    got = torch.autograd.grad(out, params, cot)
    assert calls == [3] * kernel_calls
    ref_params = [a.clone().requires_grad_() for a in arrays[1:]]
    ref = F.conv2d(x, ref_params[0],
                   ref_params[1] if len(ref_params) > 1 else None,
                   stride=parsed["stride"] or 1,
                   padding=parsed["pad"] or 0,
                   groups=parsed["num_group"])
    want = torch.autograd.grad(ref, ref_params, cot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
