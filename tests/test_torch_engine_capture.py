"""Engine capture/replay on the port (``engine.CapturedSequence``) against
the JAX package's: the same op streams through both packages' sequences
(the same replays, bails, edge lists and flush order), the counterparts of
``tests/test_engine_capture.py``, and ``Module.fit`` under
``MXNET_ENGINE_CAPTURE`` (a narrow ResNet and a narrow GQA LM) against the
JAX package's parameters and bit for bit against the port's own eager
run."""
import random
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import engine as jengine
from mxnet_tpu_torch import engine


# --- the same streams through both packages --------------------------------
def _stream(seed, iters=14):
    """Iterations of (name, reads, writes, async) over 3 var slots: a stable
    run, a deviation at a random slot, a short iteration, a stable run."""
    rng = random.Random(seed)
    base = []
    for i in range(rng.randint(2, 4)):
        w = rng.sample(range(3), rng.randint(1, 2))
        r = [v for v in rng.sample(range(3), rng.randint(0, 2)) if v not in w]
        base.append(("op%d" % i, tuple(r), tuple(w), rng.random() < 0.4))
    its = []
    dev_at = rng.randint(4, 6)
    for it in range(iters):
        ops = list(base)
        if it == dev_at:
            k = rng.randrange(len(ops))
            ops[k] = ("dev", ops[k][1], ops[k][2], False)
        if it == dev_at + 4:
            ops = ops[:-1]
        its.append(ops)
    return its


def _run_stream(pkg_engine, its):
    """Drive ``its`` through a CapturedSequence of ``pkg_engine`` with every
    op on one shared var too (so the log's order is total); returns the
    log, the per-iteration (state, replays, bails) and the compiled edges
    and names."""
    e = pkg_engine
    vs = [e.new_variable() for _ in range(3)]
    order = e.new_variable()
    cs = e.CapturedSequence(name="t_stream", warmup=2)
    log, trail, edges = [], [], []
    for it, ops in enumerate(its):
        cs.begin_step()
        for name, r, w, is_async in ops:
            const = [vs[i] for i in r]
            mut = [vs[i] for i in w] + [order]
            tag = (name, it)
            if is_async:
                cs.push_async(lambda done, tag=tag: (log.append(tag),
                                                     done()),
                              const_vars=const, mutable_vars=mut, name=name)
            else:
                cs.push(lambda tag=tag: log.append(tag), const_vars=const,
                        mutable_vars=mut, name=name)
        cs.end_step()
        trail.append((cs.state, cs.replays, cs.bails))
        if cs.state == "ready":
            edges.append([(sig[1], deps) for sig, deps in cs._ops])
    e.fence(vs + [order]).wait(30)
    for v in vs + [order]:
        e.delete_variable(v)
    return log, trail, edges


@pytest.mark.parametrize("seed", range(6))
def test_same_streams_same_replays_edges_and_flush_order(seed):
    its = _stream(seed)
    got = _run_stream(engine, its)
    want = _run_stream(jengine, its)
    assert got[1] == want[1]                 # state, replays, bails
    assert got[2] == want[2]                 # compiled edge lists
    assert got[0] == want[0]                 # every op, in the same order
    assert sorted(got[0]) == sorted((n, it) for it, ops in enumerate(its)
                                    for n, *_ in ops)


# --- the reference's capture tests on the port ------------------------------
def _drive(cs, vars_, out, it):
    """One 3-op iteration with a RAW chain a->b->c across vars_."""
    cs.begin_step()
    cs.push(lambda: out.append(("a", it)), mutable_vars=[vars_[0]], name="a")
    cs.push(lambda: out.append(("b", it)), const_vars=[vars_[0]],
            mutable_vars=[vars_[1]], name="b")
    cs.push_async(lambda done: (out.append(("c", it)), done())[1],
                  const_vars=[vars_[1]], mutable_vars=[vars_[2]], name="c")
    cs.end_step()


def test_capture_compiles_then_replays_in_dependency_order():
    out = []
    vs = [engine.new_variable() for _ in range(3)]
    cs = engine.CapturedSequence(name="t_order", warmup=2)
    for it in range(6):
        _drive(cs, vs, out, it)
    engine.fence(vs).wait(30)
    assert cs.state == "ready"
    assert cs.replays == 4 and cs.bails == 0
    pos = {e: i for i, e in enumerate(out)}
    for it in range(6):
        assert pos[("a", it)] < pos[("b", it)] < pos[("c", it)]
    for nm in "abc":
        its = [it for (n, it) in out if n == nm]
        assert its == sorted(its)
    assert out[-12:] == [(n, it) for it in range(2, 6) for n in "abc"]


def test_precomputed_edges_are_raw_war_waw():
    vs = [engine.new_variable() for _ in range(2)]
    cs = engine.CapturedSequence(name="t_edges", warmup=2)
    for _ in range(2):
        cs.begin_step()
        cs.push(lambda: None, mutable_vars=[vs[0]], name="w0")
        cs.push(lambda: None, const_vars=[vs[0]], mutable_vars=[vs[1]],
                name="r0w1")
        cs.push(lambda: None, mutable_vars=[vs[0]], name="w0b")
        cs.push(lambda: None, const_vars=[vs[1]], name="r1")
        cs.end_step()
    engine.fence(vs).wait(30)
    assert cs.state == "ready"
    deps = [d for _, d in cs.ops]
    assert deps[0] == ()
    assert deps[1] == (0,)          # RAW: reads op0's write
    assert 0 in deps[2]             # WAW on vs[0]
    assert 1 in deps[2]             # WAR: op1 read vs[0] before this write
    assert deps[3] == (1,)          # RAW on vs[1]
    for v in vs:
        engine.delete_variable(v)


def test_warmup_env_default(monkeypatch):
    monkeypatch.setenv("MXNET_ENGINE_CAPTURE_WARMUP", "4")
    assert engine.capture_warmup() == 4
    assert engine.CapturedSequence(name="t").warmup == 4
    monkeypatch.setenv("MXNET_ENGINE_CAPTURE_WARMUP", "1")
    assert engine.capture_warmup() == 2
    monkeypatch.setenv("MXNET_ENGINE_CAPTURE_WARMUP", "x")
    assert engine.capture_warmup() == 3
    monkeypatch.setenv("MXNET_ENGINE_CAPTURE", "1")
    assert engine.capture_enabled()
    monkeypatch.setenv("MXNET_ENGINE_CAPTURE", "0")
    assert not engine.capture_enabled()


def test_unstable_warmup_bails_to_eager_with_logged_reason(caplog):
    out = []
    vs = [engine.new_variable() for _ in range(2)]
    cs = engine.CapturedSequence(name="t_unstable", warmup=2)
    with caplog.at_level("INFO", logger="mxnet_tpu_torch"):
        for it in range(4):
            cs.begin_step()
            cs.push(lambda it=it: out.append(it),
                    mutable_vars=[vs[it % 2]], name="w")
            cs.end_step()
    engine.fence(vs).wait(30)
    assert cs.state == "eager" and cs.replays == 0
    assert sorted(out) == [0, 1, 2, 3]
    assert out.index(0) < out.index(2) and out.index(1) < out.index(3)
    assert any("unstable" in r.message for r in caplog.records)
    cs.invalidate("topology settled")
    cs.begin_step()
    cs.push(lambda: out.append(9), mutable_vars=[vs[0]], name="w")
    cs.end_step()
    assert cs.state == "capture"
    engine.fence(vs).wait(30)
    for v in vs:
        engine.delete_variable(v)


def test_replay_mismatch_flushes_prefix_in_order_then_recaptures():
    out = []
    vs = [engine.new_variable() for _ in range(3)]
    cs = engine.CapturedSequence(name="t_mismatch", warmup=2)
    for it in range(4):
        _drive(cs, vs, out, it)
    assert cs.state == "ready" and cs.replays == 2
    cs.begin_step()
    cs.push(lambda: out.append(("a", 99)), mutable_vars=[vs[0]], name="a")
    cs.push(lambda: out.append(("X", 99)), mutable_vars=[vs[1]], name="X")
    cs.end_step()
    engine.fence(vs).wait(30)
    assert set(out[-2:]) == {("a", 99), ("X", 99)}
    assert cs.state == "capture" and cs.bails == 1
    for it in range(2):
        _drive(cs, vs, out, 100 + it)
    assert cs.state == "ready"
    cs.begin_step()
    cs.push(lambda: out.append(("a", 200)), mutable_vars=[vs[0]], name="a")
    cs.end_step()
    engine.fence(vs).wait(30)
    assert ("a", 200) in out[-2:]
    assert cs.state == "capture" and cs.bails == 2
    for v in vs:
        engine.delete_variable(v)


def test_invalidate_from_another_thread_recaptures():
    vs = [engine.new_variable()]
    cs = engine.CapturedSequence(name="t_inval", warmup=2)
    for _ in range(3):
        cs.begin_step()
        cs.push(lambda: None, mutable_vars=vs, name="w")
        cs.end_step()
    assert cs.state == "ready"
    t = threading.Thread(target=cs.invalidate, args=("cross-thread",))
    t.start()
    t.join()
    cs.begin_step()
    assert cs.state == "capture"
    cs.push(lambda: None, mutable_vars=vs, name="w")
    cs.end_step()
    engine.fence(vs).wait(30)
    engine.delete_variable(vs[0])


def test_replay_composes_with_fence_and_async_on_complete():
    done_flags = []
    vs = [engine.new_variable()]
    gate = threading.Event()
    cs = engine.CapturedSequence(name="t_fence", warmup=2)

    def op(done):
        gate.wait(30)
        done_flags.append(1)
        done()

    for _ in range(3):
        cs.begin_step()
        cs.push_async(op, mutable_vars=vs, name="slow")
        cs.end_step()
        gate.set()
        engine.fence(vs).wait(30)
        gate.clear()
    assert cs.replays == 1
    assert len(done_flags) == 3
    gate.set()
    engine.delete_variable(vs[0])


def test_inflight_counts_replay_once_two_replicas():
    a, b = engine.new_variable(), engine.new_variable()
    engine.track_inflight(a)
    engine.track_inflight(b)
    gate = threading.Event()
    try:
        cs = engine.CapturedSequence(name="t_inflight", warmup=2)

        def seq_ops(push3):
            push3(lambda: None, "op0")
            push3(lambda: gate.wait(30), "op1")
            push3(lambda: None, "op2")

        for _ in range(2):
            gate.set()
            cs.begin_step()
            seq_ops(lambda fn, nm: cs.push(fn, mutable_vars=[a], name=nm))
            cs.end_step()
        engine.fence([a]).wait(30)
        assert cs.state == "ready"
        gate.clear()
        cs.begin_step()
        seq_ops(lambda fn, nm: cs.push(fn, mutable_vars=[a], name=nm))
        cs.end_step()
        for i in range(3):
            engine.push(lambda: gate.wait(30), mutable_vars=[b],
                        name="op%d" % i)
        assert engine.var_inflight(a) == 1  # once a replay, not an op
        assert engine.var_inflight(b) == 3
        gate.set()
        engine.fence([a, b]).wait(30)
        assert engine.var_inflight(a) == 0
        assert engine.var_inflight(b) == 0
    finally:
        gate.set()
        engine.untrack_inflight(a)
        engine.untrack_inflight(b)
        engine.delete_variable(a)
        engine.delete_variable(b)


def test_file_var_in_captured_sequence_keeps_write_order(tmp_path):
    path = str(tmp_path / "ckpt.bin")
    fv = engine.file_var(path)
    step_v = engine.new_variable()
    cs = engine.CapturedSequence(name="t_file", warmup=2)
    for it in range(5):
        cs.begin_step()
        cs.push(lambda it=it: open(path, "w").write(str(it)),
                mutable_vars=[fv], name="write")
        cs.push(lambda: None, const_vars=[fv], mutable_vars=[step_v],
                name="after")
        cs.end_step()
    assert cs.replays == 3
    engine.fence([fv, step_v]).wait(30)
    assert open(path).read() == "4"
    engine.delete_variable(step_v)


def test_sanitizer_flags_undeclared_state_and_replay_edges():
    """guard_state + a push that reaches the state without its var is a
    race; a replay whose recorded edges were stripped is flagged too."""
    was = engine.sanitizer_enabled()
    engine.sanitizer_enable(True)
    try:
        v = engine.new_variable()
        state = engine.guard_state({"x": 0}, v, "box")
        engine.push(lambda: state.__setitem__("x", 1), mutable_vars=[v],
                    name="declared")
        engine.push(lambda: state.__setitem__("x", 2), name="sneaky")
        engine.wait_for_all()
        rules = [r["rule"] for r in engine.sanitizer_reports()]
        assert rules == ["undeclared-var-access"]
        engine.sanitizer_clear()
        engine.unguard_state(state)
        v = engine.new_variable()
        gate = threading.Event()
        cs = engine.CapturedSequence(name="t_san", warmup=2)
        for it in range(3):
            cs.begin_step()
            cs.push_async(lambda done: threading.Thread(
                target=lambda: (gate.wait(10), done())).start(),
                mutable_vars=[v], name="slow")
            cs.push(lambda: None, mutable_vars=[v], name="next")
            cs.end_step()
            if it == 1:
                gate.set()
                engine.fence([v]).wait(30)
                gate.clear()
                cs._ops = [(sig, ()) for sig, _ in cs._ops]
        # the replayed "next" starts while "slow" still waits on the gate
        deadline = time.monotonic() + 30
        while not engine.sanitizer_reports() and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        gate.set()
        engine.fence([v]).wait(30)
        assert [r["rule"] for r in engine.sanitizer_reports()] == \
            ["replay-edge-violation"]
        engine.delete_variable(v)
    finally:
        engine.sanitizer_enable(was)


# --- Module.fit under capture ------------------------------------------------
def tiny_resnet(pkg):
    """A narrow ResNet: a conv-BN-ReLU stem of 4 filters, one residual
    block of two 3x3 convolutions with batch norm, global pooling, FC(5)."""
    s = pkg.sym
    data = s.Variable("data")
    x = s.Convolution(data, num_filter=4, kernel=(3, 3), pad=(1, 1),
                      no_bias=True, name="c0")
    x = s.Activation(s.BatchNorm(x, fix_gamma=False, name="bn0"),
                     act_type="relu")
    y = s.Convolution(x, num_filter=4, kernel=(3, 3), pad=(1, 1),
                      no_bias=True, name="c1")
    y = s.Activation(s.BatchNorm(y, fix_gamma=False, name="bn1"),
                     act_type="relu")
    y = s.Convolution(y, num_filter=4, kernel=(3, 3), pad=(1, 1),
                      no_bias=True, name="c2")
    y = s.BatchNorm(y, fix_gamma=False, name="bn2")
    x = s.Activation(x + y, act_type="relu")
    x = s.Pooling(x, global_pool=True, pool_type="avg", kernel=(1, 1))
    x = s.FullyConnected(s.Flatten(x), num_hidden=5, name="fc")
    return s.SoftmaxOutput(x, name="softmax")


def tiny_lm(pkg):
    """A narrow GQA LM: 1 layer, 4 query heads over 2 kv heads, d 16."""
    return pkg.models.get_symbol("transformer-lm", num_classes=29,
                                 num_layers=1, num_heads=4, model_dim=16,
                                 ffn_dim=32, num_kv_heads=2)


MODELS = {"resnet": (tiny_resnet, (3, 8, 8), (), 5, False),
          "lm": (tiny_lm, (8,), (8,), 29, True)}
ENV = ("MXNET_ENGINE_CAPTURE", "MXNET_ENGINE_FUSE",
       "MXNET_ENGINE_CAPTURE_WARMUP")


def fit_model(pkg, name, monkeypatch, env=(), steps=5, batch=4):
    """One epoch of ``steps`` batches of SGD momentum under ``env``; the
    parameters, aux states and the port module's step stats."""
    symf, shape, lshape, classes, ids = MODELS[name]
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env:
        monkeypatch.setenv(k, v)
    rng = np.random.RandomState(0)
    x = (rng.randint(0, classes, (batch * steps,) + shape) if ids
         else rng.uniform(-1, 1, (batch * steps,) + shape)).astype(np.float32)
    y = rng.randint(0, classes, (batch * steps,) + lshape).astype(np.float32)
    it = pkg.io.NDArrayIter(x, y, batch_size=batch)
    mod = pkg.mod.Module(symf(pkg), context=pkg.cpu())
    np.random.seed(7)
    init = pkg.initializer.Xavier(factor_type="in", magnitude=2)
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.05), ("momentum", 0.9),
                              ("wd", 1e-4)), initializer=init)
    args, aux = mod.get_params()
    stats = mod.fit_step_stats() if pkg is mt else None
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in aux.items()}, stats)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_module_fit_under_capture_matches_jax_and_eager(name, monkeypatch):
    want = fit_model(mx, name, monkeypatch)
    eager = fit_model(mt, name, monkeypatch)
    got = fit_model(mt, name, monkeypatch,
                    (("MXNET_ENGINE_CAPTURE", "1"),
                     ("MXNET_ENGINE_CAPTURE_WARMUP", "2")))
    eng = got[2]["engine"]
    assert eng["name"] == "fit_step" and eng["replays"] == 3
    assert eng["bails"] == 0 and eng["fused_runs"] == 0
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        assert np.array_equal(got[0][k], eager[0][k]), k
    for k in want[1]:
        assert np.array_equal(got[1][k], eager[1][k]), k


def test_fit_step_capture_invalidates_and_retires(monkeypatch):
    """A parameter reset re-warms the recording (training still right);
    a rebind drains the harness and retires its engine vars."""
    monkeypatch.setenv("MXNET_ENGINE_CAPTURE", "1")
    monkeypatch.setenv("MXNET_ENGINE_CAPTURE_WARMUP", "2")
    mod = mt.mod.Module(tiny_resnet(mt), context=mt.cpu())
    rng = np.random.RandomState(1)
    batches = [mt.io.DataBatch(
        data=[mt.nd.array(rng.uniform(-1, 1, (4, 3, 8, 8))
                          .astype(np.float32), ctx=mt.cpu())],
        label=[mt.nd.array(rng.randint(0, 5, (4,)).astype(np.float32),
                           ctx=mt.cpu())])
        for _ in range(4)]
    mod.bind(data_shapes=[("data", (4, 3, 8, 8))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params(mt.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.05),))
    for b in batches:
        mod.fit_step(b)
    cap = mod._fused_fit["capture"]
    assert cap.seq.replays == 2
    args = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
    mod.init_params(force_init=True, arg_params={
        n: mt.nd.array(v, ctx=mt.cpu()) for n, v in args.items()},
        allow_missing=True)
    for b in batches:
        mod.fit_step(b)
    mod.bind(data_shapes=[("data", (4, 3, 8, 8))],
             label_shapes=[("softmax_label", (4,))], force_rebind=True)
    assert mod._fused_fit is None
    assert cap.data_var is None and cap.step_var is None
