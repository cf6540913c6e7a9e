"""mxnet_tpu_torch.serving: the fixed-shape serving stack against the JAX
package, on the CPU.

The cases of ``tests/test_serving.py``, ``tests/test_serving_adaptive.py``
and the front door of ``tests/test_serving_generate.py`` on the port:
the batch former, bucket cache, staging pool and tuner, the server's
coalescing, bounded binds, deadlines, backpressure, lifecycle, replicas,
routers, adaptive retunes and metrics; outputs against the JAX package's
``Predictor`` on the same numpy weights (rtol 1e-5 / atol 1e-6); the
tuner's ladders equal to the reference's on seeded histograms; the front
door's ``generate()`` token for token against the JAX server's; two
decode replicas against one; the options not ported refusing.

Every server runs inside ``with`` or ``try/finally: stop()``, and every
wait has a timeout of a few seconds: the engine, former and scheduler
threads are daemons.
"""
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import predict as jpredict
from mxnet_tpu.serving import tuner as jtuner
from mxnet_tpu_torch import engine, predict, serving, telemetry
from mxnet_tpu_torch.serving import ServingConfig, ServingError
from mxnet_tpu_torch.serving.batcher import BatchFormer, Request
from mxnet_tpu_torch.serving.staging import StagingPool
from mxnet_tpu_torch.serving.tuner import BucketTuner, padded_rows

TOL = {"rtol": 1e-5, "atol": 1e-6}
WAIT = 5.0      # seconds: any one wait of a test


def _mlp_symbol(pkg=mt):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _mlp_params(seed=0):
    rng = np.random.RandomState(seed)
    shapes, _, _ = _mlp_symbol().infer_shape(data=(1, 10))
    return {n: rng.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in zip(_mlp_symbol().list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _server(replicas=1, batch_end_callback=None, **cfg_kw):
    cfg_kw.setdefault("buckets", (1, 2, 4))
    cfg_kw.setdefault("max_delay_ms", 20.0)
    cfg_kw.setdefault("timeout_ms", 5000.0)
    cfg_kw.setdefault("queue_depth", 64)
    cfg = ServingConfig(replicas=replicas, **cfg_kw)
    return serving.InferenceServer(_mlp_symbol(), _mlp_params(),
                                   {"data": (10,)}, config=cfg,
                                   devices=["cpu"] * replicas,
                                   batch_end_callback=batch_end_callback)


def _predict(srv, **inputs):
    return srv.submit(**inputs).get(WAIT)


def _run_clients(fn, n):
    threads = [threading.Thread(target=fn, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads)


def _jax_base(shape=(1, 10)):
    return jpredict.Predictor(_mlp_symbol(mx).tojson(), _mlp_params(),
                              {"data": shape})


# --- the server ---------------------------------------------------------------
def test_concurrent_requests_coalesce_with_occupancy():
    srv = _server(buckets=(1, 2, 4, 8), max_delay_ms=50.0)
    xs = np.random.RandomState(1).uniform(-1, 1, (16, 1, 10)).astype(
        np.float32)
    results = {}
    with srv:
        _run_clients(lambda i: results.__setitem__(
            i, _predict(srv, data=xs[i])), 16)
    assert len(results) == 16
    m = dict(zip(*srv.get_metrics()))
    assert m["completed"] == 16
    assert m["batches"] < 16, "no coalescing happened"
    assert m["mean_batch_occupancy"] > 1.0, m
    want = _jax_base((16, 10)).forward(data=xs[:, 0])[0].asnumpy()
    for i in range(16):
        np.testing.assert_allclose(results[i][0], want[i:i + 1], **TOL)


def test_binds_bounded_by_buckets():
    c0 = predict.compile_count()
    srv = _server(buckets=(1, 2, 4), max_delay_ms=5.0)
    rng = np.random.RandomState(2)
    with srv:
        for rows in (1, 2, 4, 3, 1, 2, 4, 1, 3, 2, 4, 1):
            x = rng.uniform(-1, 1, (rows, 10)).astype(np.float32)
            assert _predict(srv, data=x)[0].shape[0] == rows
    assert predict.compile_count() - c0 <= 3
    stats = srv.cache_stats()
    assert stats["compiles"] <= 2 and stats["hits"] >= 9, stats


def test_padded_batch_outputs_match_per_request_forward():
    srv = _server(buckets=(4,), max_delay_ms=60.0)
    rng = np.random.RandomState(3)
    xs = [rng.uniform(-1, 1, (1, 10)).astype(np.float32) for _ in range(8)]
    outs = {}
    with srv:
        _run_clients(lambda i: outs.__setitem__(i, _predict(srv,
                                                           data=xs[i])), 8)
    m = dict(zip(*srv.get_metrics()))
    assert m["mean_batch_occupancy"] > 1.0
    params = _mlp_params()
    bucket4 = predict.Predictor(_mlp_symbol().tojson(), params,
                                {"data": (4, 10)}, device="cpu")
    native = _jax_base()
    for i, x in enumerate(xs):
        padded = np.concatenate([x, np.zeros((3, 10), np.float32)], axis=0)
        same = bucket4.forward(data=padded)[0].asnumpy()[:1]
        assert np.array_equal(outs[i][0], same), i
        np.testing.assert_allclose(
            outs[i][0], native.forward(data=x)[0].asnumpy(), **TOL)


def test_deadline_exceeded_fails_structured_and_queue_drains():
    srv = _server(buckets=(1, 2, 4), max_delay_ms=1.0)
    x = np.zeros((1, 10), np.float32)
    with srv:
        doomed = srv.submit(timeout_ms=0.001, data=x)
        with pytest.raises(ServingError) as ei:
            doomed.get(WAIT)
        assert ei.value.code == "deadline_exceeded"
        assert _predict(srv, data=x)[0].shape == (1, 3)
    m = dict(zip(*srv.get_metrics()))
    assert m["completed"] >= 1 and m["errors"] >= 1
    assert srv.metrics.error_counts().get("deadline_exceeded", 0) >= 1


def test_queue_full_backpressure():
    srv = _server(buckets=(1,), queue_depth=2)
    x = np.zeros((1, 10), np.float32)
    try:
        r1, r2 = srv.submit(data=x), srv.submit(data=x)   # not started
        with pytest.raises(ServingError) as ei:
            srv.submit(data=x)
        assert ei.value.code == "queue_full"
        srv.start()
        assert r1.get(WAIT)[0].shape == (1, 3)
        assert r2.get(WAIT)[0].shape == (1, 3)
    finally:
        srv.stop()


def test_stop_without_drain_fails_queued_shutdown():
    srv = _server(buckets=(1,))
    x = np.zeros((1, 10), np.float32)
    r = srv.submit(data=x)
    srv.stop(drain=False)
    with pytest.raises(ServingError) as ei:
        r.get(WAIT)
    assert ei.value.code == "shutdown"
    with pytest.raises(ServingError) as ei:
        srv.submit(data=x)
    assert ei.value.code == "shutdown"


def test_request_validation():
    srv = _server(buckets=(1, 2))
    try:
        with pytest.raises(ServingError) as ei:
            srv.submit(data=np.zeros((3, 10), np.float32))
        assert ei.value.code == "too_large"
        with pytest.raises(ServingError):
            srv.submit(data=np.zeros((1, 7), np.float32))
        with pytest.raises(ServingError):
            srv.submit(nope=np.zeros((1, 10), np.float32))
    finally:
        srv.stop()


def test_start_after_stop_restarts_cleanly():
    srv = _server(buckets=(1, 2))
    x = np.zeros((1, 10), np.float32)
    with srv:
        assert _predict(srv, data=x)[0].shape == (1, 3)
    with pytest.raises(ServingError) as ei:
        srv.submit(data=x)
    assert ei.value.code == "shutdown"
    try:
        srv.start()
        assert _predict(srv, data=x)[0].shape == (1, 3)
    finally:
        srv.stop()


def test_replica_round_robin_dispatch():
    srv = _server(buckets=(1, 2), max_delay_ms=1.0, replicas=2)
    base = _jax_base()
    rng = np.random.RandomState(5)
    with srv:
        for _ in range(8):
            x = rng.uniform(-1, 1, (1, 10)).astype(np.float32)
            np.testing.assert_allclose(_predict(srv, data=x)[0],
                                       base.forward(data=x)[0].asnumpy(),
                                       **TOL)
    counts = srv.replica_dispatch_counts()
    assert len(counts) == 2 and all(c > 0 for c in counts), counts
    # each replica binds its own weights on its device
    a, b = (r.cache._base for r in srv._replicas)
    assert a._arg_params is not b._arg_params


def test_metrics_and_batch_end_callback():
    seen = []
    srv = _server(buckets=(1, 2), max_delay_ms=1.0,
                  batch_end_callback=seen.append)
    x = np.zeros((1, 10), np.float32)
    with srv:
        for _ in range(3):
            _predict(srv, data=x)
    assert len(seen) == 3
    p = seen[-1]
    assert p.bucket in (1, 2) and p.rows >= 1 and p.latency_ms > 0
    assert p.metrics is srv.metrics
    nv = dict(srv.metrics.get_name_value())
    for key in ("qps", "latency_ms_p50", "latency_ms_p95", "latency_ms_p99",
                "mean_batch_occupancy", "padding_efficiency", "queue_depth",
                "compile_cache_hits", "compile_cache_misses"):
        assert key in nv, key
    assert nv["qps"] > 0 and nv["latency_ms_p50"] > 0


def test_raising_batch_end_callback_is_not_a_dispatch_error():
    def bad(param):
        raise RuntimeError("user callback bug")

    srv = _server(buckets=(1,), max_delay_ms=1.0, batch_end_callback=bad)
    x = np.zeros((1, 10), np.float32)
    with srv:
        assert _predict(srv, data=x)[0].shape == (1, 3)
        assert _predict(srv, data=x)[0].shape == (1, 3)
    assert srv.metrics.error_counts() == {}


def test_ready_after_warm_and_create_server(tmp_path):
    prefix = str(tmp_path / "mlp")
    mx.model.save_checkpoint(
        prefix, 2, _mlp_symbol(mx),
        {k: mx.nd.array(v) for k, v in _mlp_params().items()}, {})
    srv = serving.create_server(
        prefix, 2, {"data": (10,)}, devices=["cpu"],
        config=ServingConfig(buckets=(1, 4), max_delay_ms=1.0, warm=True))
    with srv:
        assert srv.ready()
        assert srv.cache_stats()["compiles"] == 1     # bucket 4; 1 enrolled
        x = np.ones((1, 10), np.float32)
        np.testing.assert_allclose(_predict(srv, data=x)[0],
                                   _jax_base().forward(data=x)[0].asnumpy(),
                                   **TOL)
    assert not srv.ready()


def test_quant_weights_server_matches_the_quantized_predictor():
    srv = _server(buckets=(1, 2), max_delay_ms=1.0, quant_weights="int8")
    jq = _jax_base().quantize("int8")
    x = np.random.RandomState(6).uniform(-1, 1, (1, 10)).astype(np.float32)
    with srv:
        got = _predict(srv, data=x)[0]
    assert isinstance(srv._replicas[0].cache._base,
                      mt.quant.QuantizedPredictor)
    np.testing.assert_allclose(got, jq.forward(data=x)[0].asnumpy(), **TOL)


def test_options_not_ported_refuse():
    """The options once refused as not ported now work: ``capture`` and
    ``fuse`` build a server whose dispatch rides the engine's sequences,
    and ``restore_ladder`` without the program cache adopts nothing."""
    x = np.ones((1, 10), np.float32)
    want = None
    for kw in ({}, {"capture": True}, {"capture": True, "fuse": True}):
        srv = _server(**kw)
        with srv:
            got = [srv.predict(data=x)[0] for _ in range(5)]
            if kw:
                assert srv._replicas[0].captures
        want = got[0] if want is None else want
        assert all(np.array_equal(g, want) for g in got)
    srv = _server()
    assert srv._replicas[0].cache.restore_ladder() is False
    srv.stop()


# --- bucket cache, batch former ---------------------------------------------
def test_bucket_cache_selection_and_stats():
    base = predict.Predictor(_mlp_symbol().tojson(), _mlp_params(),
                             {"data": (1, 10)}, device="cpu")
    cache = serving.BucketCache(base, buckets=(1, 4, 8))
    assert [cache.bucket_for(r) for r in (1, 2, 5, 8)] == [1, 4, 8, 8]
    with pytest.raises(ServingError):
        cache.bucket_for(9)
    c0 = predict.compile_count()
    assert cache.get(1) is base
    assert predict.compile_count() == c0
    cache.get(4)
    cache.get(4)
    s = cache.stats()
    assert s["compiles"] == 1 and s["misses"] == 1 and s["hits"] >= 2
    cache.warm()
    assert sorted(cache.stats()["compiled"]) == [1, 4, 8]
    assert predict.compile_count() - c0 == 2
    assert cache.get(4)._arg_params is base._arg_params


def test_batch_former_window_order_and_oversize():
    f = BatchFormer(max_batch=4, max_delay_ms=30.0, queue_depth=16)
    for i in range(3):
        f.submit(Request({"i": np.full((1, 1), i, np.float32)}, 1, None))
    t0 = time.monotonic()
    batch = f.next_batch()
    assert [int(r.inputs["i"][0, 0]) for r in batch] == [0, 1, 2]
    assert time.monotonic() - t0 >= 0.01
    with pytest.raises(ServingError) as ei:
        f.submit(Request({}, 5, None))
    assert ei.value.code == "too_large" and f.depth() == 0
    f.close()
    assert f.next_batch() is None
    g = BatchFormer(max_batch=2, max_delay_ms=10_000.0, queue_depth=16)
    g.submit(Request({}, 1, None))
    g.submit(Request({}, 1, None))
    t0 = time.monotonic()
    assert len(g.next_batch()) == 2
    assert time.monotonic() - t0 < WAIT
    g.close()


def test_no_deadlock_polling_metrics_during_deadline_expiry():
    from mxnet_tpu_torch.serving.metrics import ServingMetrics

    m = ServingMetrics()
    f = BatchFormer(max_batch=8, max_delay_ms=0.5, queue_depth=1024,
                    error_hook=m.record_error)
    m._queue_depth_fn = f.depth
    stop = threading.Event()

    def poll():
        while not stop.is_set():
            m.get()

    def drain():
        while f.next_batch() is not None:
            pass

    poller = threading.Thread(target=poll, daemon=True)
    drainer = threading.Thread(target=drain, daemon=True)
    poller.start()
    drainer.start()
    for _ in range(500):
        try:
            f.submit(Request({}, 1, time.monotonic()))
        except ServingError:
            time.sleep(0.001)
    f.close()
    drainer.join(WAIT)
    stop.set()
    poller.join(WAIT)
    assert not drainer.is_alive() and not poller.is_alive()
    assert m.error_counts().get("deadline_exceeded", 0) > 0


def test_coalescing_former_prefers_full_buckets():
    f = BatchFormer(max_batch=8, max_delay_ms=1.0,
                    buckets_fn=lambda: (1, 4, 8), coalesce_fill=1.0)
    for _ in range(5):
        f.submit(Request({"data": np.zeros((1, 2), np.float32)}, 1, None))
    assert sum(r.rows for r in f.next_batch()) == 4
    assert sum(r.rows for r in f.next_batch()) == 1
    g = BatchFormer(max_batch=8, max_delay_ms=1.0,
                    buckets_fn=lambda: (4, 8), coalesce_fill=1.0)
    for _ in range(3):
        g.submit(Request({"data": np.zeros((1, 2), np.float32)}, 1, None))
    assert sum(r.rows for r in g.next_batch()) == 3


class _Req:
    def __init__(self, arr):
        self.inputs = {"data": arr}
        self.rows = arr.shape[0]


def test_staging_pool_reuses_and_rezeroes():
    p = StagingPool({"data": (3,)})
    big = p.fill([_Req(np.full((3, 3), 5.0, np.float32))], 4, ["data"])
    assert big["data"].shape == (4, 3) and not big["data"][3].any()
    small = p.fill([_Req(np.full((1, 3), 7.0, np.float32))], 4, ["data"])
    assert small["data"] is big["data"]
    assert (small["data"][0] == 7.0).all() and not small["data"][1:].any()
    assert p.allocations == 1
    # the torch view is the same memory
    t = p.tensor(4, "data")
    assert t.data_ptr() == small["data"].ctypes.data
    multi = p.fill([_Req(np.full((2, 3), 1.0, np.float32)),
                    _Req(np.full((2, 3), 2.0, np.float32))], 4, ["data"])
    assert (multi["data"][:2] == 1.0).all() and (multi["data"][2:] == 2.0).all()
    assert p.retain([8]) == [4] and p.buffer_count() == 0


@pytest.mark.parametrize("zero_copy", [True, False])
def test_assembly_outputs_match_per_row_forward(zero_copy):
    base = _jax_base()
    rng = np.random.RandomState(3)
    srv = _server(buckets=(1, 2, 4), zero_copy=zero_copy, max_delay_ms=1.0)
    with srv:
        for rows in (4, 1, 3, 1, 4, 2, 1):
            x = rng.uniform(-1, 1, (rows, 10)).astype(np.float32)
            want = np.concatenate([base.forward(data=x[i:i + 1])[0].asnumpy()
                                   for i in range(rows)], axis=0)
            np.testing.assert_allclose(_predict(srv, data=x)[0], want, **TOL)
    assert (srv._replicas[0].staging.allocations > 0) == zero_copy


# --- tuner --------------------------------------------------------------------
def _hists(seed, n):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        max_batch = int(rng.randint(1, 33))
        budget = int(rng.randint(1, 7))
        hist = {int(rng.randint(1, max_batch + 1)): int(rng.randint(1, 200))
                for _ in range(rng.randint(0, 12))}
        yield max_batch, budget, hist


def test_tuner_derive_equals_the_reference():
    for max_batch, budget, hist in _hists(7, 200):
        ladder = BucketTuner(max_batch, budget, min_samples=1).derive(hist)
        assert ladder == jtuner.BucketTuner(
            max_batch, budget, min_samples=1).derive(hist), hist
        assert ladder[-1] == max_batch and len(ladder) <= budget
        assert ladder == sorted(set(ladder))
        assert padded_rows(ladder, hist) == jtuner.padded_rows(ladder, hist)
        assert padded_rows(ladder, hist) <= padded_rows([max_batch], hist)


def test_tuner_propose_equals_the_reference():
    rng = np.random.RandomState(8)
    for max_batch, budget, hist in _hists(9, 100):
        current = sorted({int(b) for b in rng.randint(
            1, max_batch + 1, rng.randint(1, 4))} | {max_batch})
        kw = dict(min_samples=int(rng.randint(1, 200)),
                  min_improvement_pct=float(rng.choice([0.0, 1.0, 25.0])))
        assert BucketTuner(max_batch, budget, **kw).propose(hist, current) \
            == jtuner.BucketTuner(max_batch, budget, **kw).propose(
                hist, current), (hist, current)
    t = BucketTuner(8, 3, min_samples=10)
    assert t.derive({1: 50, 6: 50}) == [1, 6, 8]
    assert t.propose({6: 5}, (1, 8)) is None
    assert t.propose({1: 60, 6: 60}, (1, 8)) == [1, 6, 8]
    assert t.propose({1: 60, 6: 60}, (1, 6, 8)) is None


# --- routers, engine accounting, adaptive ladders -------------------------------
def test_engine_inflight_accounting():
    v = engine.new_variable()
    engine.track_inflight(v)
    gate = threading.Event()
    seen = []

    def op():
        seen.append(engine.var_inflight(v))
        gate.wait(WAIT)

    engine.push(op, mutable_vars=[v], name="inflight_probe")
    engine.push(lambda: None, mutable_vars=[v], name="inflight_probe2")
    t0 = time.monotonic()
    while engine.var_inflight(v) < 2 and time.monotonic() - t0 < WAIT:
        time.sleep(0.001)
    assert engine.var_inflight(v) == 2
    gate.set()
    engine.wait_for_var(v)
    assert engine.var_inflight(v) == 0 and seen in ([2], [1])
    # push_async holds its count (and the FIFO) until on_complete runs
    done = []
    engine.push_async(lambda on_complete: done.append(on_complete),
                      mutable_vars=[v], name="async_probe")
    t0 = time.monotonic()
    while not done and time.monotonic() - t0 < WAIT:
        time.sleep(0.001)
    assert engine.var_inflight(v) == 1
    done[0]()
    engine.wait_for_var(v)
    assert engine.var_inflight(v) == 0
    engine.untrack_inflight(v)
    assert engine.var_inflight(v) == 0


def test_least_loaded_routes_around_a_busy_replica():
    srv = _server(replicas=2, router="least_loaded")
    gate = threading.Event()
    try:
        busy = srv._replicas[0].var
        engine.push(lambda: gate.wait(WAIT), mutable_vars=[busy],
                    name="stall")
        picks = [srv._pick_replica().index for _ in range(4)]
        assert picks == [1, 1, 1, 1]
        assert srv.router_inflight() == [1, 0]
        rr = _server(replicas=2, router="rr")
        assert [rr._pick_replica().index for _ in range(4)] == [0, 1, 0, 1]
        rr.stop()
    finally:
        gate.set()
        srv.stop()


def test_router_inflight_gauges_exported():
    srv = _server(replicas=2, router="least_loaded")
    with srv:
        _predict(srv, data=np.zeros((1, 10), np.float32))
    nv = dict(srv.metrics.get_name_value())
    assert nv["router_inflight_replica0"] == 0
    assert nv["router_inflight_replica1"] == 0
    assert nv["bucket_ladder_version"] == 0
    expo = telemetry.registry.exposition()
    assert "serving_bucket_ladder_version" in expo
    assert "serving_router_inflight_replica0" in expo


def test_adaptive_swap_under_load():
    srv = _server(buckets=(1, 8), adaptive=True, program_budget=3,
                  retune_min_samples=16, retune_interval=0,
                  max_delay_ms=1.0, zero_copy=True)
    rng = np.random.RandomState(11)
    errors = []
    stop = threading.Event()

    def client(seed):
        r = np.random.RandomState(seed)
        while not stop.is_set():
            rows = 1 if r.rand() < 0.5 else 6
            x = r.uniform(-1, 1, (rows, 10)).astype(np.float32)
            try:
                assert _predict(srv, data=x)[0].shape[0] == rows
            except ServingError as e:
                if e.code != "queue_full":
                    errors.append(e)

    with srv:
        for _ in range(24):
            rows = int(rng.choice([1, 6]))
            _predict(srv, data=rng.uniform(-1, 1, (rows, 10)).astype(
                np.float32))
        threads = [threading.Thread(target=client, args=(s,), daemon=True)
                   for s in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.05)
        srv.retune_now(wait=True)
        time.sleep(0.2)
        stop.set()
        for t in threads:
            t.join(WAIT)
        assert srv.ladder_version >= 1
        assert 6 in srv.current_ladder() and srv.current_ladder()[-1] == 8
        assert _predict(srv, data=rng.uniform(-1, 1, (8, 10)).astype(
            np.float32))[0].shape[0] == 8
    assert not errors, errors[:3]
    compiled = srv._replicas[0].cache.stats()["compiled"]
    assert len(compiled) <= 3 and set(compiled) <= set(srv.current_ladder())
    assert dict(srv.metrics.get_name_value())["bucket_ladder_version"] >= 1


def test_retune_noop_below_min_samples_and_disabled_error():
    srv = _server(buckets=(1, 4, 8), adaptive=True, program_budget=4,
                  retune_min_samples=10 ** 6, retune_interval=1)
    with srv:
        for _ in range(5):
            _predict(srv, data=np.zeros((1, 10), np.float32))
        srv.retune_now(wait=True)
        assert srv.ladder_version == 0
        assert srv.current_ladder() == (1, 4, 8)
    static = _server(buckets=(1, 4))
    with pytest.raises(ServingError):
        static.retune_now()
    static.stop()


# --- the front door's generate() ----------------------------------------------
V, D, L, F, H, HKV = 32, 16, 2, 32, 4, 2


def _lm_params(seed=0):
    rng = np.random.RandomState(seed)
    dkv = D // H * HKV
    p = {"embed_weight": rng.randn(V, D).astype(np.float32) * 0.3}
    for i in range(L):
        pre = "layer%d" % i
        p.update({
            pre + "_ln1_gamma": np.ones(D, np.float32),
            pre + "_ln1_beta": np.zeros(D, np.float32),
            pre + "_q_weight": rng.randn(D, D).astype(np.float32) * 0.2,
            pre + "_k_weight": rng.randn(dkv, D).astype(np.float32) * 0.2,
            pre + "_v_weight": rng.randn(dkv, D).astype(np.float32) * 0.2,
            pre + "_o_weight": rng.randn(D, D).astype(np.float32) * 0.2,
            pre + "_ln2_gamma": np.ones(D, np.float32),
            pre + "_ln2_beta": np.zeros(D, np.float32),
            pre + "_ffn1_weight": rng.randn(F, D).astype(np.float32) * 0.2,
            pre + "_ffn1_bias": np.zeros(F, np.float32),
            pre + "_ffn2_weight": rng.randn(D, F).astype(np.float32) * 0.2,
            pre + "_ffn2_bias": np.zeros(D, np.float32)})
    p.update({"lnf_gamma": np.ones(D, np.float32),
              "lnf_beta": np.zeros(D, np.float32),
              "pred_weight": rng.randn(V, D).astype(np.float32) * 0.2,
              "pred_bias": np.zeros(V, np.float32)})
    return p


def _lm_server(pkg, replicas=1, slots=2, **kw):
    sym = pkg.models.get_symbol(
        "transformer-lm", num_classes=V, num_layers=L, num_heads=H,
        model_dim=D, ffn_dim=F, num_kv_heads=HKV)
    decode = pkg.serving.GenerateConfig(
        num_heads=H, num_kv_heads=HKV, slots=slots, max_context=24,
        prefill_buckets=(4, 8), max_new_tokens=6, eos_id=None, **kw)
    cfg = pkg.serving.ServingConfig(buckets=(1, 2), max_delay_ms=5.0,
                                    timeout_ms=10000.0, replicas=replicas)
    extra = {"devices": ["cpu"] * replicas} if pkg is mt else {}
    return pkg.serving.InferenceServer(
        sym, _lm_params(), {"data": (8,), "softmax_label": (8,)},
        config=cfg, decode=decode, **extra)


PROMPTS = ([3, 7, 1], [5, 9, 2, 8, 4, 4, 1], [11], [6, 6, 2, 30, 1])


def _streams(srv):
    streams = [srv.submit_stream(p, max_new_tokens=6) for p in PROMPTS]
    return [s.tokens(WAIT) for s in streams]


def test_generate_front_door_equals_the_jax_server():
    jsrv = _lm_server(mx)
    tsrv = _lm_server(mt)
    with pytest.raises(ServingError):
        tsrv.submit_stream([1, 2, 3])          # not started
    with jsrv:
        # the JAX server compiles its programs at the first streams
        want = [jsrv.submit_stream(p, max_new_tokens=6).tokens(20.0)
                for p in PROMPTS]
    with tsrv:
        # the LM's (batch*seq, V) output is not batch-major: the fixed
        # path fails with its structured error while decode keeps going
        ids = np.array([[3, 7, 1, 9, 4, 0, 0, 0]], np.float32)
        with pytest.raises(ServingError, match="batch-major") as ei:
            tsrv.submit(data=ids, softmax_label=np.zeros((1, 8), np.float32)
                        ).get(WAIT)
        assert ei.value.code == "error"
        got = [tsrv.generate(p, max_new_tokens=6, timeout_ms=WAIT * 1e3)
               for p in PROMPTS]
        stream = tsrv.submit_stream(PROMPTS[0], max_new_tokens=6)
        assert stream.tokens(WAIT) == got[0]
        st = tsrv.decode_stats()
        assert st["replicas"] == 1 and st["active"] == 0
    assert got == want
    with pytest.raises(ServingError):
        tsrv.submit_stream([1, 2, 3])          # stopped again


@pytest.mark.parametrize("paged", [False, True])
def test_two_decode_replicas_stream_as_one(paged):
    kw = {"paged": True, "block_tokens": 4} if paged else {}
    one = _lm_server(mt, replicas=1, slots=2, **kw)
    two = _lm_server(mt, replicas=2, slots=2, **kw)
    with one:
        want = _streams(one)
    with two:
        got = _streams(two)
        st = two.decode_stats()
        sched = two._decode
        assert [c.slots - len(c.active_slots()) for c in sched.caches] \
            == [2, 2]
        if paged:
            assert st["blocks_free"] == st["blocks_total"]
    assert got == want
    assert st["replicas"] == 2 and len(st["replica"]) == 2
    assert st["kv_bytes"] == 2 * one._decode.programs.kv_bytes()
    # four prompts over two replicas of two slots: both took streams
    assert all(r["eager_calls"] > 0 for r in st["replica"])
