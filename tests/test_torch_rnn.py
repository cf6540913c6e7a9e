"""mxnet_tpu_torch's RNN slice against the JAX package, on the CPU.

The same numpy inputs and weights go through both packages:

- the shape and constant ops the cells emit (SwapAxis, expand_dims,
  slice_axis, Concat, SliceChannel, broadcast_to, _zeros / _ones):
  outputs and vector-Jacobian
  products within rtol 1e-5 / atol 1e-6 (pure data movement: exact in
  practice);
- the port's plain ``lstm_step`` against the reference's Pallas kernel in
  interpret mode, and the port's fused scan (``LSTMScan``: forward by
  ``lstm_step``, backward by the plain recompute) against the reference's
  ``_lstm_scan_fused`` with that kernel in interpret mode, outputs and the
  gradients of ib, h0, c0, Wh: within 1e-5 (f32 both sides; an H-long dot
  product and the gate maths in other orders of summation);
- the ``RNN`` op in every mode, 2 layers, uni- and bidirectional, with and
  without state outputs: outputs and gradients within rtol 1e-5 / atol
  1e-6 (f32, small H: a few ulps);
- ``rnn_param_size``, the ``FusedRNN`` / ``LSTMBias`` initializers from
  one seed (bitwise: the same numpy draws), the ``pack_weights`` /
  ``unpack_weights`` round trips, and a fused cell equal to its
  ``unfuse()`` stack within rtol 1e-5 / atol 1e-6;
- ``lstm-lm`` fused and unfused at vocab 50, H 16, seq 5, batch 4, 2
  layers: the forward, every gradient, and every parameter and the
  perplexity over 3 ``Module.fit`` batches within rtol 1e-5 / atol 1e-6,
  as the MLP / LeNet fits of ``test_torch_module.py`` (f32, smooth maths).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops import rnn_fused as jrnn
from mxnet_tpu.ops.pallas import lstm as jlstm
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops import rnn_fused as trnn
from mxnet_tpu_torch.ops.kernels import lstm as tlstm

TOL = {"rtol": 1e-5, "atol": 1e-6}
STEP_TOL = {"rtol": 1e-5, "atol": 1e-5}
LM = {"num_classes": 50, "seq_len": 5, "num_embed": 16, "num_hidden": 16,
      "num_layers": 2}


def _f(*shape):
    return lambda rng: rng.randn(*shape).astype(np.float32)


# --- shape and constant ops ----------------------------------------------------
# name -> (op, input makers, attrs, differentiable input indices)
OPS = {
    "swapaxis": ("SwapAxis", [_f(2, 3, 4)], {"dim1": 0, "dim2": 2}, [0]),
    "expand_dims": ("expand_dims", [_f(2, 3)], {"axis": 1}, [0]),
    "expand_dims_neg": ("expand_dims", [_f(2, 3)], {"axis": -1}, [0]),
    "slice_axis": ("slice_axis", [_f(2, 5, 3)],
                   {"axis": 1, "begin": 1, "end": 4}, [0]),
    "slice_axis_end_none": ("slice_axis", [_f(2, 5, 3)],
                            {"axis": -1, "begin": 1, "end": None}, [0]),
    "slice_axis_end_neg": ("slice_axis", [_f(4, 3)],
                           {"axis": 0, "begin": 0, "end": -1}, [0]),
    "concat": ("Concat", [_f(2, 1, 3), _f(2, 2, 3), _f(2, 4, 3)],
               {"dim": 1, "num_args": 3}, [0, 1, 2]),
    "slice_channel": ("SliceChannel", [_f(2, 6, 3)],
                      {"num_outputs": 3, "axis": 1}, [0]),
    "slice_channel_squeeze": ("SliceChannel", [_f(2, 3, 4)],
                              {"num_outputs": 3, "axis": 1,
                               "squeeze_axis": True}, [0]),
    "broadcast_to": ("broadcast_to", [_f(1, 3, 1)], {"shape": (2, 0, 4)},
                     [0]),
    "zeros": ("_zeros", [], {"shape": (2, 3)}, []),
    "ones": ("_ones", [], {"shape": (3,), "dtype": "int32"}, []),
}


def _cots(outs, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*o.shape).astype(np.float32) for o in outs]


def _jax_op(op, arrays, attrs, diff, seed):
    """(outputs, vjp of every output with seeded cotangents) of the JAX
    op, as numpy."""
    jop = jreg.get_op(op)
    parsed = jop.parse_attrs(dict(attrs))
    xs = [jnp.asarray(a) for a in arrays]

    def f(*dx):
        ins = list(xs)
        for i, x in zip(diff, dx):
            ins[i] = x
        return tuple(jop.impl(parsed, tuple(ins), (),
                              jreg.OpContext(True, None))[0])

    outs = f(*[xs[i] for i in diff])
    if not diff:
        return [np.asarray(o) for o in outs], []
    _, vjp = jax.vjp(f, *[xs[i] for i in diff])
    cots = tuple(jnp.asarray(c) for c in _cots(outs, seed))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in vjp(cots)]


def _torch_op(op, arrays, attrs, diff, seed):
    top = treg.get_op(op)
    parsed = top.parse_attrs(dict(attrs))
    xs = [torch.from_numpy(a.copy()) for a in arrays]
    for i in diff:
        xs[i].requires_grad_()
    outs, _ = top.impl(parsed, tuple(xs), (),
                       treg.OpContext(True, torch.device("cpu")))
    got = [o.detach().numpy().copy() for o in outs]
    if not diff:
        return got, []
    cots = [torch.from_numpy(c) for c in _cots(got, seed)]
    grads = torch.autograd.grad(list(outs), [xs[i] for i in diff], cots)
    return got, [g.numpy() for g in grads]


@pytest.mark.parametrize("key", sorted(OPS))
def test_shape_and_constant_ops_match_jax(key):
    op, makers, attrs, diff = OPS[key]
    rng = np.random.RandomState(len(key))
    arrays = [m(rng) for m in makers]
    want, want_g = _jax_op(op, arrays, attrs, diff, 3)
    got, got_g = _torch_op(op, arrays, attrs, diff, 3)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert g.dtype == w.dtype, (i, g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, err_msg="output %d" % i, **TOL)
    for i, g, w in zip(diff, got_g, want_g):
        np.testing.assert_allclose(g, w, err_msg="grad %d" % i, **TOL)


def test_constant_symbols_take_the_graphs_device():
    """symbol.zeros / ones run on the executor's device; imperatively an
    input-less op reads its ctx attribute."""
    x = mt.sym.Variable("x")
    net = mt.sym.Group([x + mt.sym.zeros((2, 3)), x * mt.sym.ones((2, 3))])
    exe = net.simple_bind("cpu", x=(2, 3))
    exe.arg_dict["x"][:] = 2.0
    outs = exe.forward()
    np.testing.assert_array_equal(outs[0].asnumpy(), np.full((2, 3), 2.0))
    np.testing.assert_array_equal(outs[1].asnumpy(), np.full((2, 3), 2.0))
    z = mt.nd._zeros(shape=(2,), ctx="cpu")
    assert z.context == torch.device("cpu") and z.asnumpy().tolist() == [0, 0]
    got = mt.nd.concatenate([mt.nd.array(np.ones((1, 2)), mt.cpu()),
                             mt.nd.array(np.zeros((2, 2)), mt.cpu())])
    want = mx.nd.concatenate([mx.nd.ones((1, 2)), mx.nd.zeros((2, 2))])
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


# --- the step kernel and the fused scan ------------------------------------------
def _step_inputs(n, h, seed=0, steps=None):
    rng = np.random.RandomState(seed)
    lead = () if steps is None else (steps,)
    ib = (rng.randn(*lead, n, 4 * h) * 0.5).astype(np.float32)
    h0 = (rng.randn(n, h) * 0.5).astype(np.float32)
    c0 = rng.randn(n, h).astype(np.float32)
    wh = (rng.randn(4 * h, h) / np.sqrt(h)).astype(np.float32)
    return ib, h0, c0, wh


@pytest.mark.parametrize("n,h", [(8, 128), (4, 8), (8, 512)])
def test_plain_lstm_step_matches_pallas_interpret(n, h):
    ib, h0, c0, wh = _step_inputs(n, h)
    want = jlstm.lstm_step(*(jnp.asarray(a) for a in (ib, h0, c0, wh)),
                           interpret=True)
    got = tlstm.lstm_step(*(torch.from_numpy(a) for a in (ib, h0, c0, wh)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STEP_TOL)


def test_lstm_step_checks_shapes_and_writes_into_outputs():
    ib, h0, c0, wh = (torch.from_numpy(a) for a in _step_inputs(3, 4))
    with pytest.raises(ValueError, match="do not match"):
        tlstm.lstm_step(ib[:, :8], h0, c0, wh)
    h_out, c_out = torch.empty(3, 4), torch.empty(3, 4)
    h1, c1 = tlstm.lstm_step(ib, h0, c0, wh, h_out=h_out, c_out=c_out)
    assert h1 is h_out and c1 is c_out
    want = tlstm.lstm_step_plain(ib, h0, c0, wh)
    torch.testing.assert_close(h1, want[0])
    torch.testing.assert_close(c1, want[1])
    with pytest.raises(ValueError, match="no path for device"):
        tlstm.lstm_step(*(t.to("meta") for t in (ib, h0, c0, wh)))


def test_tiles_put_enough_blocks_in_flight():
    """The tiles the kernel's header states for H = 512: the f32 body's
    (the LM's type) fill the H100's 132 SMs to one block each but 4, and
    the simt body's tiles_for keeps its choice."""
    for n, bm in ((128, 64), (8, 16)):
        p = tlstm.plan(n, 512, "float32", (512, 1), (512, 1))
        assert p.tile == bm and p.grid[0] * p.grid[1] == 128
    assert tlstm.plan(128, 512, "bfloat16", (512, 1), (512, 1)).grid \
        == (64, 2)
    assert tlstm.tiles_for(128, 512) == (2, 4)
    assert tlstm.tiles_for(8, 512) == (1, 2)
    assert tlstm.tiles_for(32, 256) == (1, 1)
    assert tlstm.tiles_for(3, 200) == (1, 1)
    for n, h in ((128, 512), (8, 512)):
        upw, warps = tlstm.tiles_for(n, h)
        assert -(-h // (upw * warps)) * -(-n // 32) >= 132


# (n, h, dtype, h strides, wh strides, h ptr, wh ptr) -> (route, tile,
# vec_h, vec_w): the scan's layouts (ys[t - 1] rows, Wh at the blob offsets
# 4H*I and 3*4H*H), chip_smoke's odd-offset and broadcast views, and the
# bf16 layouts TMA refuses
PLAN_CASES = {
    "f32-128-scan": ((128, 512, "float32", (512, 1), (512, 1), 0, 0),
                     ("f32", 64, True, True)),
    "f32-8-scan": ((8, 512, "float32", (512, 1), (512, 1), 0, 0),
                   ("f32", 16, True, True)),
    "f32-128-views": ((128, 512, "float32", (1, 0), (512, 1), 0, 12),
                      ("f32", 64, False, False)),
    "f32-8-odd-blob": ((8, 512, "float32", (512, 1), (512, 1), 0, 12),
                       ("f32", 16, True, False)),
    "f32-3-200": ((3, 200, "float32", (200, 1), (200, 1), 0, 0),
                  ("f32", 16, True, True)),
    "f32-4-8-rows-apart": ((4, 8, "float32", (9, 1), (8, 1), 0, 0),
                           ("f32", 16, False, True)),
    "bf16-128-scan": ((128, 512, "bfloat16", (512, 1), (512, 1), 0, 0),
                      ("wgmma", 8, False, False)),
    "bf16-8-scan": ((8, 512, "bfloat16", (512, 1), (512, 1), 0, 0),
                    ("wgmma", 8, False, False)),
    "bf16-odd-blob": ((128, 512, "bfloat16", (512, 1), (512, 1), 0, 6),
                      ("simt", (2, 4), False, False)),
    "bf16-broadcast-h": ((8, 512, "bfloat16", (1, 0), (512, 1), 0, 0),
                         ("simt", (1, 2), False, False)),
    "bf16-rows-overlap": ((8, 512, "bfloat16", (0, 1), (512, 1), 0, 0),
                          ("simt", (1, 2), False, False)),
    "bf16-h200": ((3, 200, "bfloat16", (200, 1), (200, 1), 0, 0),
                  ("simt", (1, 1), False, False)),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_routes(case):
    args, (route, tile, vec_h, vec_w) = PLAN_CASES[case]
    p = tlstm.plan(*args)
    assert (p.route, p.tile, p.vec_h, p.vec_w) == (route, tile, vec_h,
                                                    vec_w)
    assert p.kernel == {"f32": tlstm.F32, "wgmma": tlstm.WGMMA,
                        "simt": tlstm.SIMT}[route]
    n, h = args[:2]
    if route == "f32":
        rows, units = tlstm.F32_TILES[tile]
    elif route == "wgmma":
        rows, units = tlstm.WG_ROWS, tlstm.WG_UNITS
    else:
        rows, units = tlstm.ROWS, tile[0] * tile[1]
    assert p.grid == (-(-h // units), -(-n // rows))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plan_of_reads_the_views_offsets_and_strides(dtype):
    """plan_of on CPU tensors laid out as the RNN op passes them: Wh in
    the packed blob at the LM's offset 4H*I, or at an odd one; h as a
    row of the scan's output, or a stride-0 broadcast."""
    h, dt = 64, getattr(torch, dtype)
    blob = torch.zeros(4 * h * h + 4 * h * h + 5, dtype=dt)
    aligned = blob[4 * h * h:8 * h * h].view(4 * h, h)
    odd = blob[3:3 + 4 * h * h].view(4 * h, h)
    ys = torch.zeros(3, 8, h, dtype=dt)
    broadcast = torch.zeros(8, 1, dtype=dt).expand(8, h)
    scan = tlstm.plan_of(ys[1], aligned)
    assert scan.route == ("f32" if dtype == "float32" else "wgmma")
    if dtype == "float32":
        assert scan.vec_h and scan.vec_w
        assert not tlstm.plan_of(ys[1], odd).vec_w
        assert not tlstm.plan_of(broadcast, aligned).vec_h
    else:
        assert tlstm.plan_of(ys[1], odd).route == "simt"
        assert tlstm.plan_of(broadcast, aligned).route == "simt"


def test_kernel_source_states_the_plans_tiles():
    """The tiles plan() assumes are the ones csrc/lstm_step.cu builds."""
    import os

    src = open(os.path.join(os.path.dirname(tlstm.__file__), "csrc",
                            "lstm_step.cu")).read()
    assert "static constexpr bool WIDE = BM == 64;" in src
    assert "static constexpr int BJ = WIDE ? %d : %d;" % (
        tlstm.F32_TILES[64][1], tlstm.F32_TILES[16][1]) in src
    assert "constexpr int BM = %d;" % tlstm.WG_ROWS in src
    assert "return wg::launch<%d>(a, s);" % tlstm.WG_UNITS in src
    assert "constexpr int ROWS = %d;" % tlstm.ROWS in src
    for upw, warps in tlstm.TILES:
        assert "return launch<%d, %d>(a, s);" % (upw, warps) in src


def _jax_fused_scan(ib, h0, c0, wh, cots):
    """Outputs and gradients of the reference's fused scan, its step
    kernel run in interpret mode (as tests/test_rnn.py patches it)."""
    orig = jlstm.lstm_step
    jlstm.lstm_step = lambda *a, **kw: orig(*a, interpret=True)
    try:
        args = [jnp.asarray(a) for a in (ib, h0, c0, wh)]
        (hl, cl), ys = jrnn._lstm_scan_fused(*args)
        _, vjp = jax.vjp(jrnn._lstm_scan_fused, *args)
        grads = vjp(((jnp.asarray(cots[1]), jnp.asarray(cots[2])),
                     jnp.asarray(cots[0])))
    finally:
        jlstm.lstm_step = orig
    return [np.asarray(x) for x in (ys, hl, cl)], [np.asarray(g)
                                                    for g in grads]


def test_fused_scan_matches_the_reference_fused_scan():
    steps, n, h = 4, 8, 16
    arrays = _step_inputs(n, h, seed=1, steps=steps)
    rng = np.random.RandomState(2)
    cots = [rng.randn(steps, n, h).astype(np.float32),
            rng.randn(n, h).astype(np.float32),
            rng.randn(n, h).astype(np.float32)]
    want, want_g = _jax_fused_scan(*arrays, cots)
    xs = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    before = tlstm.lstm_step.launches
    outs = trnn.LSTMScan.apply(*xs)
    assert tlstm.lstm_step.launches == before  # the host counts nothing
    grads = torch.autograd.grad(outs, xs, [torch.from_numpy(c)
                                           for c in cots])
    for name, g, w in zip(("ys", "h", "c"), outs, want):
        np.testing.assert_allclose(g.detach().numpy(), w, err_msg=name,
                                   **STEP_TOL)
    for name, g, w in zip(("ib", "h0", "c0", "wh"), grads, want_g):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **STEP_TOL)


def test_fused_scan_never_writes_into_broadcast_states():
    """h0 / c0 as the cells pass them (stride-0 broadcast views): read,
    never written."""
    ib, _, _, wh = (torch.from_numpy(a) for a in _step_inputs(2, 4,
                                                               steps=3))
    zero = torch.zeros(2, 1)
    h0 = zero.expand(2, 4)
    ys, hl, cl = trnn.LSTMScan.apply(ib, h0, h0, wh)
    want = trnn._lstm_scan_plain(ib, torch.zeros(2, 4), torch.zeros(2, 4),
                                 wh, 4)
    assert (zero == 0).all()
    for g, w in zip((ys, hl, cl), want):
        torch.testing.assert_close(g, w)


# --- the RNN op ----------------------------------------------------------------
RNN_CASES = [(mode, bidir, so) for mode in ("lstm", "gru", "rnn_tanh",
                                            "rnn_relu")
             for bidir in (False, True) for so in (False, True)]


@pytest.mark.parametrize("mode,bidir,state_outputs", RNN_CASES)
def test_rnn_op_matches_jax(mode, bidir, state_outputs):
    t, n, i, h, layers = 3, 2, 3, 4, 2
    dirs = 2 if bidir else 1
    size = trnn.rnn_param_size(layers, i, h, mode, bidir)
    assert size == jrnn.rnn_param_size(layers, i, h, mode, bidir)
    rng = np.random.RandomState(len(mode) + 2 * bidir + state_outputs)
    arrays = [rng.randn(t, n, i).astype(np.float32),
              rng.uniform(-0.5, 0.5, size).astype(np.float32),
              (rng.randn(layers * dirs, n, h) * 0.5).astype(np.float32)]
    if mode == "lstm":
        arrays.append((rng.randn(layers * dirs, n, h) * 0.5).astype(
            np.float32))
    attrs = {"state_size": h, "num_layers": layers, "bidirectional": bidir,
             "mode": mode, "state_outputs": state_outputs}
    diff = list(range(len(arrays)))
    want, want_g = _jax_op("RNN", arrays, attrs, diff, 5)
    got, got_g = _torch_op("RNN", arrays, attrs, diff, 5)
    assert len(got) == len(want) == (1 if not state_outputs else
                                     (3 if mode == "lstm" else 2))
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, err_msg="output %d" % k, **TOL)
    for k, g, w in zip(diff, got_g, want_g):
        np.testing.assert_allclose(g, w, err_msg="grad %d" % k, **TOL)


def test_rnn_op_refuses_dropout_in_training_only():
    """Dropout between layers acts in training only, and there it refuses
    to draw without the device's generator (no fallback to PyTorch's
    global one); with it, the output differs from the eval output, which
    equals the p = 0 output."""
    data = torch.randn(2, 1, 3)
    size = trnn.rnn_param_size(2, 3, 4, "gru")
    args = (data, torch.randn(size) * 0.1, torch.zeros(2, 1, 4))
    op = treg.get_op("RNN")
    attrs = op.parse_attrs(
        {"state_size": 4, "num_layers": 2, "mode": "gru", "p": 0.5})
    with pytest.raises(MXNetError, match="generator"):
        op.impl(attrs, args, (), treg.OpContext(True, data.device))
    (out,), _ = op.impl(attrs, args, (), treg.OpContext(False, data.device))
    assert out.shape == (2, 1, 4)
    (plain,), _ = op.impl(dict(attrs, p=0.0), args, (),
                          treg.OpContext(False, data.device))
    assert torch.equal(out, plain)
    gen = torch.Generator().manual_seed(0)
    (drop,), _ = op.impl(attrs, args, (), treg.OpContext(
        True, data.device, rng=gen))
    assert drop.shape == (2, 1, 4) and not torch.equal(drop, out)


@pytest.mark.parametrize("layers,i,h,mode,bidir", [
    (2, 512, 512, "lstm", False), (1, 7, 5, "gru", True),
    (3, 4, 6, "rnn_relu", True), (2, 3, 8, "rnn_tanh", False)])
def test_rnn_param_size_matches_jax(layers, i, h, mode, bidir):
    assert trnn.rnn_param_size(layers, i, h, mode, bidir) \
        == jrnn.rnn_param_size(layers, i, h, mode, bidir)


# --- initializers and weight packing -------------------------------------------
@pytest.mark.parametrize("inner,mode,bidir", [
    (None, "lstm", False), ("xavier", "lstm", False), ("uniform", "gru", True),
    ("xavier", "rnn_tanh", True), (None, "lstm", True)])
def test_fused_rnn_initializer_matches_jax_from_one_seed(inner, mode, bidir):
    size = trnn.rnn_param_size(2, 5, 6, mode, bidir)
    blobs = []
    for pkg in (mt, mx):
        init = {None: None, "xavier": pkg.initializer.Xavier(),
                "uniform": pkg.initializer.Uniform(0.2)}[inner]
        fused = pkg.initializer.FusedRNN(init, num_hidden=6, num_layers=2,
                                         mode=mode, bidirectional=bidir,
                                         forget_bias=1.5)
        arr = pkg.nd.zeros((size,), pkg.cpu())
        np.random.seed(11)
        fused(pkg.initializer.InitDesc("lstm_parameters"), arr)
        blobs.append(arr.asnumpy())
    np.testing.assert_array_equal(blobs[0], blobs[1])
    if mode == "lstm":
        assert (blobs[0] == 1.5).sum() == 2 * (2 if bidir else 1) * 6


def test_generic_initializers_reach_the_blob_through_its_attribute():
    """Module.init_params(Xavier()) fills the fused cell's blob through
    the FusedRNN attribute, and the unfused LSTMCell's i2h bias through
    LSTMBias, as the reference does."""
    for fused in (True, False):
        params = []
        for pkg in (mt, mx):
            sym = pkg.models.get_symbol("lstm-lm", fused=fused, **LM)
            mod = pkg.mod.Module(sym, context=pkg.cpu())
            mod.bind([("data", (4, 5))], [("softmax_label", (4, 5))])
            np.random.seed(3)
            mod.init_params(pkg.initializer.Xavier())
            params.append({k: v.asnumpy() for k, v in
                           mod.get_params()[0].items()})
        assert sorted(params[0]) == sorted(params[1])
        for k in params[1]:
            np.testing.assert_array_equal(params[0][k], params[1][k], k)


def _cell_args(shapes, seed):
    rng = np.random.RandomState(seed)
    return {k: mt.nd.array(rng.randn(*s).astype(np.float32), mt.cpu())
            for k, s in shapes.items()}


def test_lstm_cell_unpack_pack_matches_jax_and_round_trips():
    names = {"lstm_i2h_weight": (16, 3), "lstm_i2h_bias": (16,),
             "lstm_h2h_weight": (16, 4), "lstm_h2h_bias": (16,)}
    args = _cell_args(names, 0)
    got = mt.rnn.LSTMCell(4, prefix="lstm_").unpack_weights(args)
    want = mx.rnn.LSTMCell(4, prefix="lstm_").unpack_weights(
        {k: mx.nd.array(v.asnumpy()) for k, v in args.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].asnumpy(), want[k].asnumpy())
    back = mt.rnn.LSTMCell(4, prefix="lstm_").pack_weights(got)
    for k, v in args.items():
        np.testing.assert_array_equal(back[k].asnumpy(), v.asnumpy())


@pytest.mark.parametrize("mode,bidir", [("lstm", False), ("gru", True),
                                        ("rnn_relu", False)])
def test_fused_unpack_pack_round_trips_to_unfused_names(mode, bidir):
    cell = mt.rnn.FusedRNNCell(4, num_layers=2, mode=mode,
                               bidirectional=bidir, prefix="f_")
    size = trnn.rnn_param_size(2, 3, 4, mode, bidir)
    blob = mt.nd.array(np.random.RandomState(1).randn(size).astype(
        np.float32), mt.cpu())
    unpacked = cell.unpack_weights({"f_parameters": blob, "other": blob})
    assert "f_parameters" not in unpacked and "other" in unpacked
    # per-gate names: the unfused stack's cells unpack to the same names
    stack = cell.unfuse()
    packed = stack.pack_weights(dict(unpacked))
    assert stack.unpack_weights(packed).keys() == unpacked.keys()
    for k, v in stack.unpack_weights(packed).items():
        np.testing.assert_array_equal(v.asnumpy(), unpacked[k].asnumpy())
    again = cell.pack_weights(unpacked)
    np.testing.assert_array_equal(again["f_parameters"].asnumpy(),
                                  blob.asnumpy())


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
def test_fused_cell_equals_its_unfuse(mode):
    """The same weights through the fused RNN op and through the unfused
    cells (converted with unpack_weights / pack_weights) give the same
    outputs."""
    t, n, i, h = 4, 3, 5, 6
    data = mt.sym.Variable("data")
    fused = mt.rnn.FusedRNNCell(h, num_layers=2, mode=mode, prefix="m_")
    outs = []
    rng = np.random.RandomState(4)
    x = rng.randn(n, t, i).astype(np.float32)
    blob = rng.uniform(-0.4, 0.4, trnn.rnn_param_size(2, i, h, mode)).astype(
        np.float32)
    for cell in (fused, fused.unfuse()):
        out, _ = cell.unroll(t, inputs=data, merge_outputs=True,
                             layout="NTC")
        exe = out.simple_bind("cpu", data=(n, t, i))
        args = fused.unpack_weights({"m_parameters": mt.nd.array(
            blob, mt.cpu())})
        if cell is fused:
            args = fused.pack_weights(args)
        else:
            args = cell.pack_weights(args)
        exe.copy_params_from(args)
        exe.arg_dict["data"][:] = x
        outs.append(exe.forward()[0].asnumpy())
    assert outs[0].shape == (n, t, h)
    np.testing.assert_allclose(outs[0], outs[1], **TOL)


def test_cells_unroll_like_jax():
    """Explicit cells (sequential, residual, bidirectional) unrolled in
    both packages over the same weights and inputs."""
    def build(pkg):
        stack = pkg.rnn.SequentialRNNCell()
        stack.add(pkg.rnn.GRUCell(4, prefix="g_"))
        stack.add(pkg.rnn.ResidualCell(pkg.rnn.RNNCell(4, prefix="r_")))
        bi = pkg.rnn.BidirectionalCell(pkg.rnn.LSTMCell(3, prefix="bl_"),
                                       pkg.rnn.LSTMCell(3, prefix="br_"))
        out, _ = stack.unroll(3, inputs=pkg.sym.Variable("data"),
                              merge_outputs=True)
        out2, states = bi.unroll(3, inputs=out, merge_outputs=True)
        return pkg.sym.Group([out2] + states)

    syms = [build(mt), build(mx)]
    assert syms[0].list_arguments() == syms[1].list_arguments()
    shapes = {"data": (2, 3, 4)}
    arg_shapes, _, _ = syms[1].infer_shape(**shapes)
    rng = np.random.RandomState(9)
    params = {k: rng.randn(*s).astype(np.float32) * 0.5
              for k, s in zip(syms[1].list_arguments(), arg_shapes)}
    outs = []
    for pkg, sym in zip((mt, mx), syms):
        exe = sym.simple_bind(pkg.cpu(), grad_req="null", **shapes)
        exe.copy_params_from(params)
        outs.append([o.asnumpy() for o in exe.forward()])
    for g, w in zip(*outs):
        np.testing.assert_allclose(g, w, **TOL)


# --- the LSTM language model ------------------------------------------------------
@pytest.mark.parametrize("fused", [True, False])
def test_lstm_lm_forward_and_gradients_match_jax(fused):
    shapes = {"data": (4, 5), "softmax_label": (4, 5)}
    syms = [pkg.models.get_symbol("lstm-lm", fused=fused, **LM)
            for pkg in (mt, mx)]
    assert syms[0].list_arguments() == syms[1].list_arguments()
    arg_shapes, _, _ = syms[1].infer_shape(**shapes)
    assert syms[0].infer_shape(**shapes)[0] == arg_shapes
    rng = np.random.RandomState(5)
    params = {k: rng.uniform(-0.3, 0.3, s).astype(np.float32)
              for k, s in zip(syms[1].list_arguments(), arg_shapes)
              if k not in shapes}
    feed = {"data": rng.randint(0, 50, (4, 5)).astype(np.float32),
            "softmax_label": rng.randint(0, 50, (4, 5)).astype(np.float32)}
    reqs = {k: "null" if k in shapes else "write" for k in syms[1]
            .list_arguments()}
    runs = []
    for pkg, sym in zip((mt, mx), syms):
        exe = sym.simple_bind(pkg.cpu(), grad_req=reqs, **shapes)
        exe.copy_params_from(dict(params, **feed))
        exe.forward(is_train=True)
        exe.backward()
        runs.append((exe.outputs[0].asnumpy(),
                     {k: exe.grad_dict[k].asnumpy() for k in params}))
    np.testing.assert_allclose(runs[0][0], runs[1][0], **TOL)
    for k in params:
        assert np.abs(runs[1][1][k]).max() > 0, k
        np.testing.assert_allclose(runs[0][1][k], runs[1][1][k], err_msg=k,
                                   **TOL)


def _fit_lm(pkg, fused):
    sym = pkg.models.get_symbol("lstm-lm", fused=fused, **LM)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 50, (12, 5)).astype(np.float32)
    y = rng.randint(0, 50, (12, 5)).astype(np.float32)
    it = pkg.io.NDArrayIter(x, y, batch_size=4)
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    mod.bind(it.provide_data, it.provide_label)
    np.random.seed(7)
    init = pkg.initializer.Xavier()
    mod.init_params(init)
    states, metrics = [], []

    def record(param):
        states.append({k: v.asnumpy().copy()
                       for k, v in mod.get_params()[0].items()})
        metrics.append(param.eval_metric.get_name_value()[0][1])

    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.5),), initializer=init,
            eval_metric=pkg.metric.Perplexity(None),
            batch_end_callback=record)
    score = mod.score(it, pkg.metric.Perplexity(None))[0][1]
    return states, metrics, score


@pytest.mark.parametrize("fused", [True, False])
def test_lstm_lm_module_fit_matches_jax(fused):
    got_s, got_m, got_score = _fit_lm(mt, fused)
    want_s, want_m, want_score = _fit_lm(mx, fused)
    assert len(got_s) == len(want_s) == 3
    for g, w in zip(got_s, want_s):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)
    np.testing.assert_allclose(got_m, want_m, **TOL)
    np.testing.assert_allclose(got_score, want_score, **TOL)
