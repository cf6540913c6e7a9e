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


# the chip_smoke cases (ResNet-50's seven 3x3 shapes at batch 32 and the
# oracle's odd ones, f32 and bf16), without importing the script here
RESNET_3X3 = [(56, 64, 1), (56, 128, 2), (28, 128, 1), (28, 256, 2),
              (14, 256, 1), (14, 512, 2), (7, 512, 1)]
ODD = [(2, 8, 8, 16, 3, 1), (2, 9, 8, 16, 3, 1), (2, 8, 8, 16, 3, 2),
       (1, 5, 4, 8, 1, 1), (4, 7, 16, 32, 3, 1)]
CASES = [case + (dtype,) for dtype in ("float32", "bfloat16")
         for case in [(32, h, c, c, 3, s) for h, c, s in RESNET_3X3] + ODD]


def test_cases_are_chip_smokes():
    import chip_smoke as cs

    assert CASES == cs.wgrad_cases()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plan_covers_l_exactly_and_repacked_strides_are_16_bytes(case):
    n, h, c, k, ksz, s, dtype = case
    pad = (ksz - 1) // 2
    oh = cw.out_size(h, ksz, s, pad)
    p = cw.plan(n, h, h, c, k, ksz, s, pad, dtype)
    assert p.chunk % p.step == 0 and 1 <= p.splits <= 65535
    assert (p.splits - 1) * p.chunk < p.units <= p.splits * p.chunk
    if (h, c, s) in RESNET_3X3 and n == 32:
        assert p.route == ("f32" if dtype == "float32" else "wgmma")
    if p.route != "wgmma":
        assert p.box is None and p.units == n * oh * oh
        assert p.tiles == (cw._cdiv(ksz * ksz * c, p.bn if p.route == "simt"
                                    else cw.TILE_M) * cw._cdiv(k, p.bn))
        return
    assert dtype == "bfloat16" and p.bn in cw.BLOCK_COLS
    bw, bh, bi = p.box
    assert bw * bh * bi == cw.WG_ROWS
    assert all(v & (v - 1) == 0 for v in p.box)
    # the L tiles' boxes cover every (n, oh, ow) exactly once
    covered = np.zeros((cw._cdiv(n, bi) * bi, cw._cdiv(oh, bh) * bh,
                        cw._cdiv(oh, bw) * bw), np.int32)
    wb, hb = cw._cdiv(oh, bw), cw._cdiv(oh, bh)
    assert p.units == cw._cdiv(n, bi) * hb * wb
    for t in range(p.units):
        ow0, oh0, n0 = (t % wb) * bw, (t // wb % hb) * bh, t // wb // hb * bi
        covered[n0:n0 + bi, oh0:oh0 + bh, ow0:ow0 + bw] += 1
    assert (covered == 1).all()
    # TMA: every byte stride and plane base of the repacked bf16 x and dy
    for stride_bytes in (2 * c, s * 2 * c, s * h * 2 * c, h * h * 2 * c,
                         2 * k, oh * 2 * k, oh * oh * 2 * k):
        assert stride_bytes % 16 == 0
    for hp in range(s):
        for wp in range(s):
            assert (hp * h + wp) * c * 2 % 16 == 0


@pytest.mark.parametrize("m,k,l", [(576, 64, 100352), (4608, 512, 1568),
                                   (1152, 128, 25088)])
def test_splits_fill_whole_rounds_of_resident_blocks(m, k, l):
    """The f32 plan puts the most whole blocks of a round on the card, at
    least, and the round model it minimizes is within 5% of every other
    choice from that many up."""
    splits, chunk = cw.splits_for(m, k, l)
    bn = 64 if k <= 64 else 128
    tiles = cw._cdiv(m, cw.TILE_M) * cw._cdiv(k, bn)
    slots = cw.RESIDENT[(cw.F32, bn)] * cw.SMS
    assert splits >= min(slots // tiles, l // cw.MIN_SPLIT_ROWS)
    cost = cw._cdiv(tiles * splits, slots) / splits + splits * \
        cw.reduce_cost(l, cw.RATE["f32"])
    for other in range(1, 64):
        ch = cw._cdiv(cw._cdiv(l, other), cw.TILE_L) * cw.TILE_L
        if ch < cw.MIN_SPLIT_ROWS or other < slots // tiles:
            continue
        o = cw._cdiv(l, ch)
        assert cost <= 1.05 * (cw._cdiv(tiles * o, slots) / o + o *
                               cw.reduce_cost(l, cw.RATE["f32"])) + 1e-12


def test_repack_then_plain_equals_plain_on_the_nchw_views():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 9, 9, generator=gen)             # NCHW, f32
    dy = torch.randn(2, 24, 5, 5, generator=gen)
    xv, dv = x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1)
    xr, dr = cw.repack(xv), cw.repack(dv)
    for r, v in ((xr, xv), (dr, dv)):
        assert r.dtype == torch.bfloat16 and r.is_contiguous()
        assert r.shape == v.shape and r.data_ptr() % 16 == 0
        assert torch.equal(r, v.to(torch.bfloat16))
    assert cw.repack(xr) is xr
    got = cw.conv_wgrad_plain(xr, dr, 3, 2, 1)
    want = cw.conv_wgrad_plain(xv.to(torch.bfloat16), dv.to(torch.bfloat16),
                               3, 2, 1)
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * scale)
    # a misaligned contiguous bf16 view is copied to a 16-byte boundary
    flat = torch.zeros(1 + 2 * 9 * 9 * 16, dtype=torch.bfloat16)
    view = flat[1:].view(2, 9, 9, 16)
    assert view.data_ptr() % 16 and cw.repack(view).data_ptr() % 16 == 0


def _tap_shift(kh, kw, stride, pad):
    """(plane, dw, dh) of tap (kh, kw), as csrc/conv_wgrad.cu's tap_of:
    floor division and a remainder in [0, stride)."""
    qh, qw = kh - pad, kw - pad
    dh, dw = qh // stride, qw // stride
    return (qh - dh * stride) * stride + (qw - dw * stride), dw, dh


def _box(t, n0, h0, w0, bi, bh, bw):
    """A TMA box of (N, H, W, C) ``t`` at (n0, h0, w0): zeros outside."""
    out = torch.zeros((bi, bh, bw, t.shape[3]), dtype=t.dtype)
    n, h, w = t.shape[:3]
    ns, hs, ws = (slice(max(a, 0), min(a + e, lim))
                  for a, e, lim in ((n0, bi, n), (h0, bh, h), (w0, bw, w)))
    if ns.start < ns.stop and hs.start < hs.stop and ws.start < ws.stop:
        out[ns.start - n0:ns.stop - n0, hs.start - h0:hs.stop - h0,
            ws.start - w0:ws.stop - w0] = t[ns, hs, ws]
    return out


def _emulate_wgmma(x, dy, ksz, stride, pad, p):
    """The wgmma route's arithmetic on the CPU: repacked operands, x as
    stride * stride parity planes, each L tile one box of dy and each
    tap's box of x shifted in its plane, per split, the splits summed in
    order (f32 products of the bf16 values)."""
    xr, dr = cw.repack(x).float(), cw.repack(dy).float()
    n, h, w, c = x.shape
    _, oh, ow, k = dy.shape
    bw, bh, bi = p.box
    wb, hb = cw._cdiv(ow, bw), cw._cdiv(oh, bh)
    planes = [xr[:, hp::stride, wp::stride] for hp in range(stride)
              for wp in range(stride)]
    ws = torch.zeros((p.splits, ksz, ksz, c, k))
    for z in range(p.splits):
        for t in range(z * p.chunk, min((z + 1) * p.chunk, p.units)):
            ow0, oh0, n0 = (t % wb) * bw, (t // wb % hb) * bh, \
                t // wb // hb * bi
            b = _box(dr, n0, oh0, ow0, bi, bh, bw).reshape(-1, k)
            for kh in range(ksz):
                for kw in range(ksz):
                    plane, dw, dh = _tap_shift(kh, kw, stride, pad)
                    a = _box(planes[plane], n0, oh0 + dh, ow0 + dw, bi, bh,
                             bw).reshape(-1, c)
                    ws[z, kh, kw] += a.t() @ b
    out = ws[0].clone()
    for z in range(1, p.splits):
        out += ws[z]
    return out


@pytest.mark.parametrize("n,h,c,k,ksz,stride,splits", [
    (2, 8, 8, 16, 3, 1, 1), (2, 9, 8, 16, 3, 1, 2), (2, 8, 8, 16, 3, 2, 1),
    (4, 7, 16, 32, 3, 1, 3), (2, 8, 64, 64, 3, 2, 1), (3, 12, 8, 8, 1, 2, 2),
    (2, 10, 16, 8, 3, 2, 2)])
def test_wgmma_route_tiling_matches_plain(n, h, c, k, ksz, stride, splits):
    """The parity planes, the box shifts by floor((k - pad) / stride), the
    zero fill and the split plan reproduce the convolution's dW."""
    pad = (ksz - 1) // 2
    oh = cw.out_size(h, ksz, stride, pad)
    gen = torch.Generator().manual_seed(n * h + c)
    x = torch.randn(n, c, h, h, generator=gen).permute(0, 2, 3, 1)
    dy = torch.randn(n, k, oh, oh, generator=gen).permute(0, 2, 3, 1)
    p = cw.plan_of(x.to(torch.bfloat16), dy, ksz, stride, pad)
    assert p.route == "wgmma"
    chunk = cw._cdiv(p.units, splits)
    p = p._replace(splits=cw._cdiv(p.units, chunk), chunk=chunk)
    got = _emulate_wgmma(x, dy, ksz, stride, pad, p)
    want = cw.conv_wgrad_plain(x.to(torch.bfloat16), dy.to(torch.bfloat16),
                               ksz, stride, pad)
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * scale)


def test_routes_of_the_odd_cases():
    """bf16 with C or K off a multiple of 8, or a stride that does not
    divide H, takes the simt route; f32 always the f32 route."""
    assert cw.plan(1, 5, 5, 4, 8, 1, 1, 0, "bfloat16").route == "simt"
    assert cw.plan(2, 9, 9, 8, 16, 3, 2, 1, "bfloat16").route == "simt"
    assert cw.plan(2, 8, 8, 8, 16, 3, 3, 1, "bfloat16").route == "simt"
    assert cw.plan(2, 8, 8, 8, 16, 3, 2, 1, "bfloat16").route == "wgmma"
    assert cw.plan(1, 5, 5, 4, 8, 1, 1, 0, "float32").route == "f32"
    with pytest.raises(TypeError):
        cw.plan(1, 5, 5, 4, 8, 1, 1, 0, "float16")


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


def test_wgrad_variants_edit_the_current_source(monkeypatch):
    """tools/wgrad_variants.py: every variant's edits still find their
    text exactly once in the kernel source, each edited variant differs
    from it, and its shapes are chip_smoke.py's."""
    import os

    import chip_smoke as cs
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.tools import wgrad_variants as wv

    with open(os.path.join(_build.CSRC, "conv_wgrad.cu")) as f:
        source = f.read()
    for name, (dtype, edits, resident, repack) in wv.VARIANTS.items():
        assert dtype in ("bfloat16", "float32")
        assert (wv.variant_source(name) == source) == (not edits), name
        assert set(resident) <= set(cw.RESIDENT)
    assert wv.RESNET_WGRAD == cs.RESNET_WGRAD
    x = torch.randn(2, 8, 5, 5).permute(0, 2, 3, 1)
    assert torch.equal(wv._torch_repack(x), cw.repack(x))
    monkeypatch.setitem(wv.VARIANTS, "gone", ("float32", [("no such", "")],
                                               {}, None))
    with pytest.raises(ValueError, match="occurs 0 times"):
        wv.variant_source("gone")


def test_wgmma_splits_sum_at_most_max_split_units():
    """No wgmma split sums more than MAX_SPLIT_UNITS tiles one after
    another (the rounding of that f32 sum grows with its length); ssd's
    long sums (37 x 37 x 256 -> 512 was 3 splits of 395 tiles) now split
    further, ResNet-50's plans are unchanged; every plan still covers L."""
    import chip_smoke as cs
    from mxnet_tpu_torch.tools.image_zoo import wgrad_shapes
    from mxnet_tpu_torch.tools.ssd import SSD, ssd_symbol

    shapes = set(wgrad_shapes(ssd_symbol(SSD), SSD["image"], 32)) | set(
        cs.zoo_wgrad_shapes(cs.IMAGE_ZOO))
    wgmma = 0
    for n, h, w, c, k, stride, pad in shapes:
        p = cw.plan(n, h, w, c, k, 3, stride, pad, "bfloat16")
        if p.route != "wgmma":
            continue
        wgmma += 1
        assert p.chunk <= cw.MAX_SPLIT_UNITS
        assert (p.splits - 1) * p.chunk < p.units <= p.splits * p.chunk
    assert wgmma > 50
    assert cw.plan(32, 37, 37, 256, 512, 3, 1, 1, "bfloat16").splits > 3
    assert [cw.plan(32, h, h, c, c, 3, s, 1, "bfloat16")[7:]
            for h, c, s in RESNET_3X3] == [
        (78, 23), (28, 16), (28, 16), (7, 19), (7, 19), (1, 32), (1, 32)]
    assert cw.pick_splits(4, 264, 1000, 1, 4, 0.0, max_units=100)[1] <= 100
