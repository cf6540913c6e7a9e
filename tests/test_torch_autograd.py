"""mxnet_tpu_torch.autograd against the JAX package's, on the CPU.

Counterparts of ``tests/test_autograd.py``: the same numpy inputs go
through both packages' imperative autograd (``attach_grad`` /
``mark_variables``, ``record``, ``backward``), and every gradient must
agree within rtol 1e-5 / atol 1e-6 (f32 both sides; elementwise ops, a
small sum and a 3 x 4 x 2 product: a few ulps at most). The reference's
expression tests (square, exp + sum, two variables, dot + sum, head
gradients, a repeated backward) are cases of one parametrised test. The
reference's training-flag test reads the flag through Dropout, which the
port does not have yet; here the flag reaches BatchNorm, whose output
differs between training (batch statistics) and prediction (moving
statistics), in both packages.
"""
import gc

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError

TOL = {"rtol": 1e-5, "atol": 1e-6}
CTX = {mt: "cpu", mx: None}


def _nd(pkg, a):
    return pkg.nd.array(np.asarray(a, np.float32), ctx=CTX[pkg])


def _zeros(pkg, shape):
    return pkg.nd.zeros(shape, ctx=CTX[pkg])


def _square(pkg, x):
    return x * x


def _exp_sum(pkg, x):
    return pkg.nd.sum(pkg.nd.exp(x))


def _two_variables(pkg, a, b):
    return a * b + a


def _dot_sum(pkg, a, b):
    return pkg.nd.sum(pkg.nd.dot(a, b))


def _scale(pkg, x):
    return x * 4.0


def _repeated(pkg, x):
    return pkg.nd.sum(x * float(1.0))


# name -> (expression, input shapes, head gradient or None, backward rounds)
CASES = {
    "simple_grad": (_square, [(3,)], None, 1),
    "chain": (_exp_sum, [(3, 4)], None, 1),
    "two_variables": (_two_variables, [(3,), (3,)], None, 1),
    "matmul_grad": (_dot_sum, [(3, 4), (4, 2)], None, 1),
    "head_grads": (_scale, [(2,)], np.array([2.0, 3.0], np.float32), 1),
    "repeated_backward": (_repeated, [(4,)], None, 5),
}


def _grads(pkg, case, arrays):
    fn, _, head_grad, rounds = CASES[case]
    xs = [_nd(pkg, a) for a in arrays]
    if len(xs) == 1:
        xs[0].attach_grad()
    else:
        pkg.autograd.mark_variables(xs, [_zeros(pkg, x.shape) for x in xs])
    for _ in range(rounds):
        with pkg.autograd.record():
            y = fn(pkg, *xs)
        y.backward(None if head_grad is None else _nd(pkg, head_grad))
    return y.asnumpy(), [x.grad.asnumpy() for x in xs]


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(case):
    rng = np.random.RandomState(sorted(CASES).index(case))
    arrays = [rng.rand(*s).astype(np.float32) for s in CASES[case][1]]
    got_y, got = _grads(mt, case, arrays)
    want_y, want = _grads(mx, case, arrays)
    np.testing.assert_allclose(got_y, want_y, **TOL)
    for g, w in zip(got, want):
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g, w, **TOL)


def _add_req(pkg):
    x = _nd(pkg, np.ones(3))
    grad = _zeros(pkg, 3)
    pkg.autograd.mark_variables([x], [grad], "add")
    for _ in range(2):
        with pkg.autograd.record():
            y = x * 3.0
        y.backward()
    return grad.asnumpy()


def test_grad_add_req_accumulates_like_jax():
    got = _add_req(mt)
    np.testing.assert_allclose(got, _add_req(mx), **TOL)
    np.testing.assert_allclose(got, np.full(3, 6.0), **TOL)


def _batch_norm(pkg, train_mode):
    rng = np.random.RandomState(3)
    x = _nd(pkg, rng.randn(4, 3, 2, 2))
    gamma, beta = _nd(pkg, rng.rand(3) + 0.5), _nd(pkg, rng.randn(3))
    mean, var = _nd(pkg, rng.randn(3)), _nd(pkg, rng.rand(3) + 0.5)
    with pkg.autograd.record(train_mode=train_mode):
        flags = (pkg.autograd.is_recording(), pkg.autograd.is_training())
        y = pkg.nd.BatchNorm(x, gamma, beta, mean, var, fix_gamma=False)
    return flags, y.asnumpy(), mean.asnumpy()


@pytest.mark.parametrize("train_mode", [True, False])
def test_training_flag_reaches_the_ops_like_jax(train_mode):
    flags, y, moving = _batch_norm(mt, train_mode)
    want_flags, want_y, want_moving = _batch_norm(mx, train_mode)
    assert flags == want_flags == (True, train_mode)
    np.testing.assert_allclose(y, want_y, **TOL)
    np.testing.assert_allclose(moving, want_moving, **TOL)
    assert not mt.autograd.is_recording() and not mt.autograd.is_training()


def test_scopes_restore_the_flags():
    ag = mt.autograd
    with ag.record():
        with ag.pause():
            assert not ag.is_recording() and not ag.is_training()
        with ag.predict_mode():
            assert ag.is_recording() and not ag.is_training()
        assert ag.is_recording() and ag.is_training()
    with ag.train_mode():
        assert ag.is_training() and not ag.is_recording()
    assert ag.set_recording(True) is False
    assert ag.set_recording(False) is True
    assert not ag.is_recording()


def test_grad_returns_fresh_arrays_like_jax():
    a_np = np.random.RandomState(1).rand(3).astype(np.float32)
    out = []
    for pkg in (mt, mx):
        a = _nd(pkg, a_np)
        a.attach_grad()
        with pkg.autograd.record():
            y = a * a * 2.0
        (g,) = pkg.autograd.grad([y], [a])
        out.append(g.asnumpy())
    np.testing.assert_allclose(out[0], out[1], **TOL)
    np.testing.assert_allclose(out[0], 4 * a_np, **TOL)


def test_a_variable_is_marked_before_its_ops_are_recorded():
    """PyTorch's graph starts at tensors that required grad when the op
    ran: a variable marked after the fact (which the JAX package's tape
    replay allows) raises instead of giving a silent zero."""
    a = _nd(mt, [1.0, 2.0])
    b = _nd(mt, [3.0, 4.0])
    b.attach_grad()
    with mt.autograd.record():
        y = a * b
    with pytest.raises(MXNetError, match="before"):
        mt.autograd.grad([y], [a])


def test_null_req_skips_and_unused_variables_get_zeros():
    ag, nd = mt.autograd, mt.nd
    a, b, c = (_nd(mt, [1.0, 2.0]) for _ in range(3))
    ga, gb, gc_ = (_nd(mt, [7.0, 7.0]) for _ in range(3))
    ag.mark_variables([a, b, c], [ga, gb, gc_], ["write", "null", "write"])
    with ag.record():
        y = nd.sum(a * b)
    y.backward()
    np.testing.assert_allclose(ga.asnumpy(), [1.0, 2.0])
    np.testing.assert_allclose(gb.asnumpy(), [7.0, 7.0])
    np.testing.assert_allclose(gc_.asnumpy(), [0.0, 0.0])
    with pytest.raises(MXNetError, match="grad_req"):
        ag.mark_variables([a], [ga], "sometimes")


def test_in_place_writes_keep_the_variable_and_outside_record_nothing_is_kept():
    ag, nd = mt.autograd, mt.nd
    x = _nd(mt, [1.0, 2.0, 3.0])
    x.attach_grad()
    x[:] = np.array([2.0, 3.0, 4.0], np.float32)    # into the leaf's storage
    y = x * x                                        # not recorded
    assert not y._data.requires_grad
    with pytest.raises(MXNetError, match="not computed under record"):
        y.backward()
    with ag.record():
        z = nd.sum(x * x)
    z.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [4.0, 6.0, 8.0])


def test_marked_variables_are_held_weakly():
    ag = mt.autograd
    x = _nd(mt, [1.0])
    x.attach_grad()
    key = id(x)
    assert key in ag._state.marked
    del x
    gc.collect()
    ag._live_marked()
    assert key not in ag._state.marked


def test_asnumpy_is_a_copy_on_the_host_too():
    x = _nd(mt, [1.0, 2.0])
    view = x.asnumpy()
    view[0] = 5.0
    np.testing.assert_allclose(x.asnumpy(), [1.0, 2.0])
