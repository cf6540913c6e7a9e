"""The sequence ops and the creation / sampling ops of the port, against
the JAX package, on the CPU.

``SequenceMask`` / ``SequenceLast`` / ``SequenceReverse`` forward and
input gradient on seeded inputs (lengths 0, 1, full and mixed; ``axis`` 0
and 1; with and without ``use_sequence_length``) and
``softmax_cross_entropy``, through both packages' imperative autograd:
within rtol 1e-5 / atol 1e-6 (f32 both sides; the ops select, mask and
sum a few values, so only a log-softmax's last bits can differ). The
creation ops (``_full``, ``_arange`` with ``repeat``, ``_eye``,
``zeros_like``, ``nd.arange``, ``sym.arange``) equal exactly. The sampling
ops: shapes and types, moments at 2^16 elements within 5 sigma of the
distribution's, one seed repeating and two seeds differing (the port's
generator is not JAX's, so draws are not compared value for value). Then
a 3-batch ``Module.fit`` of the sequence classifier of
``tools/seq_classify.py`` at a tiny width under ``FactorScheduler``,
against the JAX package from the same weights: each step's lr equal and
the parameters within 1e-5.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops.registry import OP_REGISTRY as JOPS
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import OP_REGISTRY as TOPS
from mxnet_tpu_torch.tools import seq_classify as sc

TOL = {"rtol": 1e-5, "atol": 1e-6}
CTX = {mt: "cpu", mx: None}
NEW_OPS = ("SequenceMask", "SequenceLast", "SequenceReverse",
           "softmax_cross_entropy", "_full", "_arange", "_eye", "zeros_like",
           "_random_uniform", "_random_normal", "_random_gamma",
           "_random_exponential", "uniform", "normal", "_sample_uniform",
           "_sample_normal")


def _nd(pkg, a):
    return pkg.nd.array(np.asarray(a, np.float32), ctx=CTX[pkg])


def test_the_new_ops_are_registered_with_the_reference_signatures():
    # 133 with these; the optimizer zoo's slice added rmsprop_update,
    # rmspropalex_update, clip, sign and norm (138), the core-op slice the
    # 87 of test_torch_ops_core.py (225), ssd's slice the nine contrib ops
    # (234, every op of the JAX package's registry)
    assert len(TOPS) == 234
    assert not [n for n in NEW_OPS if n not in TOPS]
    for name in NEW_OPS:
        j, t = JOPS[name], TOPS[name]
        assert set(t.param_spec) == set(j.param_spec), name
        assert tuple(t.no_grad_inputs) == tuple(j.no_grad_inputs), name
        assert t.needs_rng == j.needs_rng, name
        for use in (False, True):
            attrs = {"use_sequence_length": use}
            assert t.get_arg_names(attrs) == j.get_arg_names(attrs), name
    assert TOPS["uniform"] is TOPS["_random_uniform"]
    assert TOPS["_sample_normal"] is TOPS["_random_normal"]


LENGTHS = {"zero": [0, 0, 0], "one": [1, 1, 1], "full": [6, 6, 6],
           "mixed": [0, 3, 6]}


def _run(pkg, op, x, lens, head, kw):
    """(output, d output / d data) of ``op`` through ``pkg``'s autograd."""
    data = _nd(pkg, x)
    data.attach_grad()
    args = [data] + ([_nd(pkg, lens)] if kw.get("use_sequence_length")
                     else [])
    with pkg.autograd.record():
        y = getattr(pkg.nd, op)(*args, **kw)
    y.backward(_nd(pkg, head))
    return y.asnumpy(), data.grad.asnumpy()


SEQ_CASES = [(op, axis, lengths)
             for op in ("SequenceMask", "SequenceLast", "SequenceReverse")
             for axis in (0, 1)
             for lengths in (None,) + tuple(sorted(LENGTHS))]


@pytest.mark.parametrize("case", range(len(SEQ_CASES)),
                         ids=["%s-axis%d-%s" % (op, ax, ln or "nolen")
                              for op, ax, ln in SEQ_CASES])
def test_sequence_op_equals_the_jax_package(case):
    op, axis, lengths = SEQ_CASES[case]
    use = lengths is not None
    rng = np.random.RandomState(case)
    # (T, B, C) at axis 0, (B, T, C) at axis 1; B = 3, T = 6
    shape = (6, 3, 4) if axis == 0 else (3, 6, 4)
    if op == "SequenceReverse" and use:
        shape = (6, 3, 4)        # reverses axis 0 whatever axis says
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    kw = {"use_sequence_length": use, "axis": axis}
    if op == "SequenceMask":
        kw["value"] = -2.5
    lens = LENGTHS[lengths] if use else None
    probe = getattr(mt.nd, op)(*([_nd(mt, x)] + (
        [_nd(mt, lens)] if use else [])), **kw).shape
    head = rng.uniform(-1, 1, probe).astype(np.float32)
    want = _run(mx, op, x, lens, head, kw)
    got = _run(mt, op, x, lens, head, kw)
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)


def test_sequence_last_of_length_zero_is_step_zero_and_lengths_truncate():
    x = np.arange(24, dtype=np.float32).reshape(4, 3, 2)
    out = mt.nd.SequenceLast(_nd(mt, x), _nd(mt, [0, 2.9, 4]),
                             use_sequence_length=True).asnumpy()
    np.testing.assert_array_equal(out, np.stack([x[0, 0], x[1, 1],
                                                 x[3, 2]]))


def test_sequence_ops_in_a_symbol_infer_and_refuse_a_missing_length():
    data, lens = mt.sym.Variable("data"), mt.sym.Variable("len")
    net = mt.sym.SequenceLast(mt.sym.SequenceMask(
        data, lens, use_sequence_length=True), lens,
        use_sequence_length=True)
    assert net.list_arguments() == ["data", "len"]
    _, out, _ = net.infer_shape(data=(5, 2, 3), len=(2,))
    assert out == [(5, 2, 3)[1:]]
    with pytest.raises(MXNetError):
        mt.nd.SequenceMask(_nd(mt, np.zeros((2, 2))), _nd(mt, [1, 1]),
                           use_sequence_length=False, bogus=1)


def test_softmax_cross_entropy_equals_the_jax_package():
    rng = np.random.RandomState(7)
    x = rng.uniform(-3, 3, (5, 7)).astype(np.float32)
    label = np.array([0, 6, 3, 3, 1], np.float32)
    outs = {}
    for pkg in (mx, mt):
        data = _nd(pkg, x)
        data.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.softmax_cross_entropy(data, _nd(pkg, label))
        y.backward()
        outs[pkg] = (y.asnumpy(), data.grad.asnumpy())
    assert outs[mt][0].shape == outs[mx][0].shape == ()
    for a, b in zip(outs[mt], outs[mx]):
        np.testing.assert_allclose(a, b, **TOL)


# --- creation ops ---------------------------------------------------------------
CREATE = [
    ("_full", {"shape": (2, 3), "value": 2.5}),
    ("_full", {"shape": (4,), "value": -1, "dtype": "int32"}),
    ("_arange", {"start": 0, "stop": 5}),
    ("_arange", {"start": -3, "stop": 7, "step": 0.5, "repeat": 3}),
    ("_arange", {"start": 6}),
    ("_arange", {"start": 10, "stop": 1, "step": -2.25, "repeat": 2}),
    ("_arange", {"start": 0, "stop": 9, "step": 1, "dtype": "int32"}),
    ("_eye", {"N": 4}),
    ("_eye", {"N": 3, "M": 5, "k": 2}),
    ("_eye", {"N": 5, "M": 3, "k": -1, "dtype": "float16"}),
]


@pytest.mark.parametrize("name,kw", CREATE,
                         ids=["%s%d" % (c[0], i) for i, c in
                              enumerate(CREATE)])
def test_creation_op_equals_the_jax_package_exactly(name, kw):
    want = getattr(mx.nd, name)(**kw).asnumpy()
    got = getattr(mt.nd, name)(ctx="cpu", **kw).asnumpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_zeros_like_and_both_arange_helpers_equal_the_jax_package():
    x = np.random.RandomState(0).uniform(-1, 1, (3, 2)).astype(np.float32)
    np.testing.assert_array_equal(mt.nd.zeros_like(_nd(mt, x)).asnumpy(),
                                  mx.nd.zeros_like(_nd(mx, x)).asnumpy())
    for args, kw in (((5,), {}), ((1, 4, 0.5), {"repeat": 2}),
                     ((2, 8, 3), {"dtype": "int32"})):
        want = mx.nd.arange(*args, **kw).asnumpy()
        got = mt.nd.arange(*args, ctx="cpu", **kw).asnumpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        sw, st = mx.sym.arange(*args, **kw), mt.sym.arange(*args, **kw)
        assert st.infer_shape()[1] == sw.infer_shape()[1]
        jv = sw.bind(mx.cpu(), {}).forward()[0].asnumpy()
        tv = st.simple_bind("cpu").forward()[0].asnumpy()
        np.testing.assert_array_equal(tv, jv)


# --- sampling ops ---------------------------------------------------------------
def _within_5_sigma(draw, name, attrs):
    mean, var, m4 = sc.moments(name, attrs)
    n = draw.size
    d = draw.astype(np.float64)
    assert abs(d.mean() - mean) <= 5 * np.sqrt(var / n), (name, d.mean())
    assert abs(d.var() - var) <= 5 * np.sqrt((m4 - var * var) / n), \
        (name, d.var())


@pytest.mark.parametrize("name,attrs", sc.RANDOM_OPS,
                         ids=[r[0] for r in sc.RANDOM_OPS])
def test_sampling_op_moments_seeds_and_types(name, attrs):
    op = getattr(mt.nd, name)
    mt.random.seed(11)
    a = op(shape=(1 << 16,), ctx="cpu", **attrs).asnumpy()
    assert a.shape == (1 << 16,) and a.dtype == np.float32
    _within_5_sigma(a, name, attrs)
    mt.random.seed(11)
    b = op(shape=(1 << 16,), ctx="cpu", **attrs).asnumpy()
    np.testing.assert_array_equal(a, b)            # one seed repeats
    c = op(shape=(1 << 16,), ctx="cpu", **attrs).asnumpy()
    assert not np.array_equal(b, c)                # the draw advances
    mt.random.seed(12)
    d = op(shape=(1 << 16,), ctx="cpu", **attrs).asnumpy()
    assert not np.array_equal(a, d)                # another seed differs
    h = op(shape=(2, 3), ctx="cpu", dtype="float16", **attrs)
    assert h.shape == (2, 3) and h.asnumpy().dtype == np.float16
    want = getattr(mx.nd, name)(shape=(2, 3), **attrs)
    assert want.shape == h.shape


def test_aliases_draw_as_their_ops():
    for alias, name in (("uniform", "_random_uniform"),
                        ("_sample_normal", "_random_normal")):
        mt.random.seed(3)
        a = getattr(mt.nd, alias)(shape=(64,), ctx="cpu").asnumpy()
        mt.random.seed(3)
        b = getattr(mt.nd, name)(shape=(64,), ctx="cpu").asnumpy()
        np.testing.assert_array_equal(a, b)


def test_sampling_in_a_graph_draws_from_the_device_generator():
    """A symbol with a sampling op: each forward advances the generator,
    and a seed brings the first draw back."""
    net = mt.sym.Variable("x") + mt.sym._random_normal(shape=(4, 3))
    exe = net.simple_bind("cpu", x=(4, 3))
    mt.random.seed(5)
    a = exe.forward(x=np.zeros((4, 3), np.float32))[0].asnumpy()
    b = exe.forward(x=np.zeros((4, 3), np.float32))[0].asnumpy()
    mt.random.seed(5)
    c = exe.forward(x=np.zeros((4, 3), np.float32))[0].asnumpy()
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a, c)


# --- the classifier under a schedule -------------------------------------------
TINY = dict(sc.SEQ, vocab=50, embed=16, hidden=16, seq=5, batch=4,
            batches=3)


def test_seq_classifier_fit_under_factor_scheduler_equals_the_jax_package():
    cfg = TINY
    mod, it, init = sc.seq_setup(cfg, cfg["batch"], cfg["batches"],
                                 device="cpu")
    init_args = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    lrs, jlrs = [], []
    mod.fit(it, batch_end_callback=lambda p: lrs.append(
        float(mod._fused_fit["step"]._extra[0][0])),
        **sc.fit_args(cfg, init))
    jmod = mx.mod.Module(sc.seq_symbol(cfg, mx), data_names=sc.DATA_NAMES)
    jit = sc.seq_iter(cfg, cfg["batch"], cfg["batches"], sc.SEED + 1, mx)
    jmod.bind(jit.provide_data, jit.provide_label)
    jmod.init_params(arg_params={k: mx.nd.array(v)
                                 for k, v in init_args.items()})
    jargs = sc.fit_args(cfg, None, mx)
    sched = dict(jargs["optimizer_params"])["lr_scheduler"]
    jmod.fit(jit, batch_end_callback=lambda p: jlrs.append(sched.base_lr),
             **jargs)
    want = sc.lr_sequence(cfg, cfg["batches"])
    assert want == [0.1, 0.1, 0.05]
    assert jlrs == want
    np.testing.assert_allclose(lrs, want, rtol=1e-7)   # f32 on the device
    assert mod.fit_step_stats()["path"] == "eager"
    got = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    ref = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert not np.array_equal(got[k], init_args[k]), k
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5)
