"""Trace-and-fuse on the port (``MXNET_ENGINE_FUSE``): a stable
``CapturedSequence`` whose ops carry ``engine.FuseOp`` runs as one stitched
torch function (one CUDA graph on a card, eagerly here). The counterparts
of ``tests/test_engine_fuse.py``: registers carried across iterations,
feeds evaluated each iteration, writebacks, and every bail back to replay
with the same values; ``Module.fit`` (a narrow ResNet and a narrow GQA LM)
against the JAX package and bit for bit against the port's eager run; the
fused serving dispatch bit for bit against the eager server."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import engine, telemetry

from test_torch_engine_capture import MODELS, fit_model


@pytest.fixture(autouse=True)
def _clean_tracer():
    telemetry.reset()
    telemetry.disable_spans()
    yield
    telemetry.disable_spans()
    telemetry.reset()


def _braid(name, host, v, warmup=2, second_fuse=True):
    """A 2-op (+1)*(2) chain over one var; ``second_fuse=False`` drops the
    second op's metadata, which keeps the sequence on replay."""
    cs = engine.CapturedSequence(name=name, warmup=warmup, fuse=True)

    def add():
        host["x"] = host["x"] + 1.0

    def mul():
        host["x"] = host["x"] * 2.0

    f_add = engine.FuseOp(lambda x: (x + 1.0,), in_vars=(v,), out_vars=(v,),
                          init={v: lambda: host["x"]},
                          fingerprint="t_fuse:add")
    f_mul = engine.FuseOp(lambda x: (x * 2.0,), in_vars=(v,), out_vars=(v,),
                          writeback=lambda d: host.__setitem__("x", d[v]),
                          fingerprint="t_fuse:mul")

    def one_iter():
        cs.begin_step()
        cs.push(add, mutable_vars=(v,), name="t_add", fuse=f_add)
        cs.push(mul, mutable_vars=(v,), name="t_mul",
                fuse=(f_mul if second_fuse else None))
        cs.end_step()

    return cs, one_iter


def _ref(n, size):
    ref = np.zeros((size,), np.float32)
    for _ in range(n):
        ref = (ref + 1.0) * 2.0
    return ref


def test_fused_sequence_matches_eager_reference():
    v = engine.new_variable()
    engine.track_inflight(v)
    host = {"x": torch.zeros(4)}
    before = engine.fused_stats()
    cs, one_iter = _braid("t_fuse_basic", host, v)
    for _ in range(6):
        one_iter()
    engine.fence([v]).wait(30)
    assert cs.state == "ready" and cs._fuse_state == "staged"
    assert cs.fused_runs == 4 and cs.fuse_bails == 0 and cs.replays == 0
    assert cs.fused.runs == 4 and cs.fused.device is None
    after = engine.fused_stats()
    assert after["runs"] - before["runs"] == 4
    assert after["compiles"] - before["compiles"] == 1
    assert after["captures"] == before["captures"]   # eager on the CPU
    assert engine.var_inflight(v) == 0
    assert np.array_equal(host["x"].numpy(), _ref(6, 4))
    engine.untrack_inflight(v)
    engine.delete_variable(v)


def test_op_without_fuse_metadata_marks_sequence_ineligible():
    v = engine.new_variable()
    host = {"x": torch.zeros(4)}
    before = engine.fused_stats()
    cs, one_iter = _braid("t_fuse_inel", host, v, second_fuse=False)
    for _ in range(6):
        one_iter()
    engine.fence([v]).wait(30)
    assert cs.state == "ready"
    assert cs._fuse_state == "ineligible"
    assert cs.fused_runs == 0 and cs.replays == 4
    after = engine.fused_stats()
    assert after["ineligible"] - before["ineligible"] == 1
    assert after["bails"] - before["bails"] >= 1
    assert np.array_equal(host["x"].numpy(), _ref(6, 4))
    engine.delete_variable(v)


def test_feed_drift_bails_iteration_to_replay():
    """A feed whose type drifts bails before any side effect; that
    iteration and the later ones replay the closures: no fork."""
    v = engine.new_variable()
    host = {"x": torch.zeros(3)}
    drift = {"on": False}

    def feed():
        return (torch.tensor(1, dtype=torch.int32 if drift["on"]
                             else torch.float32),)

    def add():
        host["x"] = host["x"] + feed()[0]

    f_add = engine.FuseOp(lambda x, inc: (x + inc,), in_vars=(v,),
                          out_vars=(v,), feed=feed,
                          init={v: lambda: host["x"]},
                          writeback=lambda d: host.__setitem__("x", d[v]),
                          fingerprint="t_fuse:drift")
    cs = engine.CapturedSequence(name="t_fuse_drift", warmup=2, fuse=True)
    for it in range(8):
        drift["on"] = it >= 5
        cs.begin_step()
        cs.push(add, mutable_vars=(v,), name="t_add", fuse=f_add)
        cs.end_step()
        engine.fence([v]).wait(30)
    assert cs.fused_runs == 4 and cs.fuse_bails == 1
    assert cs._fuse_state == "dead"
    assert cs.replays == 2
    assert np.array_equal(host["x"].numpy(), np.full((3,), 8.0, np.float32))
    engine.delete_variable(v)


def test_liveness_carries_reads_and_materializes_written_registers():
    """A var read before written is carried (seeded once from init); one
    written first is an intermediate, materialized for its writeback."""
    a, b = engine.new_variable(), engine.new_variable()
    host = {"acc": torch.zeros(2), "out": None}
    f1 = engine.FuseOp(lambda acc: (acc + 1.0, acc * 3.0), in_vars=(a,),
                       out_vars=(a, b), init={a: lambda: host["acc"]},
                       fingerprint="t:1")
    f2 = engine.FuseOp(lambda y: (y - 1.0,), in_vars=(b,), out_vars=(b,),
                       writeback=lambda d: host.__setitem__("out", d[b]),
                       fingerprint="t:2")

    def step1():
        host["tmp"] = host["acc"] * 3.0
        host["acc"] = host["acc"] + 1.0

    def step2():
        host["out"] = host["tmp"] - 1.0

    cs = engine.CapturedSequence(name="t_live", warmup=2, fuse=True)
    for _ in range(5):
        cs.begin_step()
        cs.push(step1, mutable_vars=(a, b), name="s1", fuse=f1)
        cs.push(step2, mutable_vars=(b,), name="s2", fuse=f2)
        cs.end_step()
    engine.fence([a, b]).wait(30)
    prog = cs.fused
    assert len(prog._carried_idx) == 1 and len(prog._mat_idx) == 1
    assert cs.fused_runs == 3
    # acc went 0, 1, 2 eagerly, then the fused carry 2 -> 5 over 3 runs;
    # the last run's intermediate is 4 * 3 - 1
    assert np.array_equal(host["out"].numpy(), np.full((2,), 11.0,
                                                       np.float32))
    for v in (a, b):
        engine.delete_variable(v)


def test_fused_run_span_roundtrip_and_counters():
    nv0 = dict(telemetry.registry.get_name_value())
    telemetry.enable_spans("engine")
    v = engine.new_variable()
    host = {"x": torch.zeros(2)}
    cs, one_iter = _braid("t_fuse_tele", host, v)
    for _ in range(5):
        one_iter()
    engine.fence([v]).wait(30)
    assert cs.fused_runs == 3
    evs = telemetry.drain_events()
    fused = [e for e in evs if e[1] == "engine.fused_run"]
    assert len(fused) == 3
    for e in fused:
        assert e[2] == "engine"
        assert e[5]["ops"] == 2 and e[5]["sequence"] == "t_fuse_tele"
        assert e[5]["signature"] == cs.fused.signature[:12]
    nv = dict(telemetry.registry.get_name_value())
    assert nv["engine_fused_runs_total"] == \
        nv0.get("engine_fused_runs_total", 0) + 3
    assert nv["engine_fuse_bails_total"] == \
        nv0.get("engine_fuse_bails_total", 0)
    engine.delete_variable(v)


def test_sanitizer_clean_then_flags_tampered_edges():
    was_on = engine.sanitizer_enabled()
    engine.sanitizer_enable(True)
    try:
        v = engine.new_variable()
        host = {"x": torch.zeros(2)}
        cs, one_iter = _braid("t_fuse_san", host, v)
        for _ in range(5):
            one_iter()
        engine.fence([v]).wait(30)
        assert cs._fuse_state == "staged" and cs.fused_runs == 3
        assert [r for r in engine.sanitizer_reports()
                if r["rule"] == "fused-edge-violation"] == []
        cs._ops = [(sig, ()) for sig, _ in cs._ops]
        engine.sanitizer_enable(True)
        one_iter()
        engine.fence([v]).wait(30)
        viol = [r for r in engine.sanitizer_reports()
                if r["rule"] == "fused-edge-violation"]
        assert viol and "t_fuse_san" in viol[0]["site"]
        engine.delete_variable(v)
    finally:
        engine.sanitizer_enable(was_on)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_module_fit_fused_matches_jax_and_eager(name, monkeypatch):
    want = fit_model(mx, name, monkeypatch)
    eager = fit_model(mt, name, monkeypatch)
    got = fit_model(mt, name, monkeypatch,
                    (("MXNET_ENGINE_CAPTURE", "1"),
                     ("MXNET_ENGINE_FUSE", "1"),
                     ("MXNET_ENGINE_CAPTURE_WARMUP", "2")))
    eng = got[2]["engine"]
    assert eng["fuse_state"] == "staged"
    assert eng["fused_runs"] == 3 and eng["fuse_bails"] == 0
    assert eng["replays"] == 0
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        assert np.array_equal(got[0][k], eager[0][k]), k
    for k in want[1]:
        assert np.array_equal(got[1][k], eager[1][k]), k


def _fc_server(capture, fuse, buckets=(4,)):
    in_dim = 10
    data = mt.sym.Variable("data")
    sym = mt.sym.FullyConnected(data, num_hidden=4, name="fc")
    rng = np.random.RandomState(0)
    params = {"fc_weight": rng.uniform(-0.1, 0.1, (4, in_dim))
              .astype(np.float32),
              "fc_bias": rng.uniform(-0.1, 0.1, (4,)).astype(np.float32)}
    cfg = mt.serving.ServingConfig(buckets=buckets, max_delay_ms=0.5,
                                   capture=capture, fuse=fuse, warm=True)
    return mt.serving.InferenceServer(sym, params, {"data": (in_dim,)},
                                      config=cfg, devices=["cpu"])


def _serve(capture, fuse, rows=2, n=10):
    srv = _fc_server(capture, fuse)
    outs = []
    with srv:
        r = np.random.RandomState(1)
        for _ in range(n):
            x = r.uniform(-1, 1, (rows, 10)).astype(np.float32)
            outs.append(np.asarray(srv.predict(data=x)[0]))
        stats = srv.capture_stats()
    return outs, stats


def test_serving_fused_dispatch_matches_eager_bit_for_bit():
    o_eager, _ = _serve(False, False)
    o_cap, st_cap = _serve(True, False)
    o_fused, st = _serve(True, True)
    seq = st[0][4]
    assert seq["fuse_state"] == "staged"
    assert seq["fused_runs"] == 7 and seq["fuse_bails"] == 0
    assert seq["fused_program_runs"] == 7 and seq["fused_replays"] == 0
    assert st_cap[0][4]["replays"] == 7
    for a, b, c in zip(o_eager, o_cap, o_fused):
        assert np.array_equal(a, b) and np.array_equal(a, c)


def test_serving_fused_dispatch_bails_on_bucket_drift():
    """A ladder swap under a staged program: the next dispatch's
    ``acquire()`` resolves another bucket and the iteration replays."""
    srv = _fc_server(True, True, buckets=(2, 4))
    x = np.ones((2, 10), np.float32)
    with srv:
        want = srv.predict(data=x)[0]
        for _ in range(4):
            srv.predict(data=x)
        seq = srv._replicas[0].captures[2]
        assert seq.fused_runs == 2 and seq.fused is not None
        # the nominal bucket stays 2 but acquire() now resolves 4
        srv._replicas[0].cache.set_ladder([4])
        got = srv.predict(data=x)[0]
        assert seq.fuse_bails == 1
    assert np.allclose(got, want, rtol=0, atol=1e-6)
