"""The port's native dependency engine (``mxnet_tpu_torch/native/engine.cc``)
against the JAX package's: the counterparts of ``tests/test_engine.py`` on
the port, and the same op streams through both packages' engines in one
process (their libraries and C symbols are distinct)."""
import ctypes
import random
import threading
import time

import numpy as np
import pytest

from mxnet_tpu import engine as jeng
from mxnet_tpu_torch import engine as eng
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture()
def E():
    e = eng.NativeEngine(num_workers=4)
    yield e
    e.wait_for_all()


def test_get_is_the_native_threaded_engine(monkeypatch):
    monkeypatch.setattr(eng, "_engine", None)
    monkeypatch.delenv("MXNET_ENGINE_TYPE", raising=False)
    e = eng.get()
    assert type(e).__name__ == "NativeEngine"
    assert e.engine_type == "ThreadedEngine"
    monkeypatch.setattr(eng, "_engine", None)
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    e = eng.get()
    v = e.new_variable()
    out = []
    e.push(lambda: out.append(1), mutable_vars=[v])
    assert out == [1] and e.engine_type == "NaiveEngine"


def test_library_has_its_own_symbols_beside_the_jax_packages():
    """Both engines live in one process: the port's library exports
    mxtt_engine_* and none of the JAX package's mxe_* entry points."""
    lib = eng._load_native()
    assert hasattr(lib, "mxtt_engine_push")
    with pytest.raises(AttributeError):
        getattr(lib, "mxe_push")
    je = jeng.NativeEngine(num_workers=2)
    te = eng.NativeEngine(num_workers=2)
    out = []
    jv, tv = je.new_variable(), te.new_variable()
    for i in range(5):
        je.push(lambda i=i: out.append(("j", i)), mutable_vars=[jv])
        te.push(lambda i=i: out.append(("t", i)), mutable_vars=[tv])
    je.wait_for_all()
    te.wait_for_all()
    assert [i for k, i in out if k == "j"] == list(range(5))
    assert [i for k, i in out if k == "t"] == list(range(5))


def test_build_failure_raises(monkeypatch, tmp_path):
    from mxnet_tpu_torch.ops.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    with pytest.raises(MXNetError, match="g\\+\\+ not found"):
        _build.build_host("mxtt_engine", eng.NATIVE_SRC)


def test_write_write_serializes(E):
    v = E.new_variable()
    log = []
    for i in range(20):
        E.push(lambda i=i: log.append(i), mutable_vars=[v])
    E.wait_for_var(v)
    assert log == list(range(20))


def test_read_read_concurrent(E):
    v = E.new_variable()
    barrier = threading.Barrier(2, timeout=10)
    hits = []

    def reader(i):
        barrier.wait()  # both readers must be in flight at once to pass
        hits.append(i)

    E.push(lambda: reader(0), const_vars=[v])
    E.push(lambda: reader(1), const_vars=[v])
    E.wait_for_all()
    assert sorted(hits) == [0, 1]


def test_read_blocks_later_write(E):
    v = E.new_variable()
    order = []
    release = threading.Event()

    def slow_read():
        release.wait(10)
        order.append("read")

    E.push(slow_read, const_vars=[v])
    E.push(lambda: order.append("write"), mutable_vars=[v])
    time.sleep(0.05)
    release.set()
    E.wait_for_all()
    assert order == ["read", "write"]


def test_wait_for_var_observes_prior_writes(E):
    v = E.new_variable()
    box = []
    for i in range(5):
        E.push(lambda i=i: (time.sleep(0.01), box.append(i)),
               mutable_vars=[v])
    E.wait_for_var(v)
    assert box == list(range(5))


def test_push_async_completion(E):
    v = E.new_variable()
    got = []

    def async_op(on_complete):
        def later():
            time.sleep(0.05)
            got.append("async")
            on_complete()

        threading.Thread(target=later).start()

    E.push_async(async_op, mutable_vars=[v])
    E.push(lambda: got.append("after"), const_vars=[v])
    E.wait_for_all()
    assert got == ["async", "after"]


def test_delete_variable_runs_after_uses(E):
    v = E.new_variable()
    log = []
    E.push(lambda: (time.sleep(0.02), log.append("use")), mutable_vars=[v])
    E.delete_variable(v)
    E.wait_for_all()
    assert log == ["use"]


def test_dedup_read_and_write_same_var(E):
    v = E.new_variable()
    E.push(lambda: None, const_vars=[v, v], mutable_vars=[v, v])
    E.wait_for_all()
    assert eng._dedup([v, v, 3], [v]) == jeng._dedup([v, v, 3], [v])


def _random_dag(e, seed, nvars=12, nops=300):
    rng = random.Random(seed)
    vars_ = [e.new_variable() for _ in range(nvars)]
    state = {i: [] for i in range(nvars)}
    expected = {i: [] for i in range(nvars)}
    for opid in range(nops):
        k = rng.randint(1, 4)
        chosen = rng.sample(range(nvars), k)
        nwrite = rng.randint(1, k)
        writes, reads = chosen[:nwrite], chosen[nwrite:]

        def op(writes=tuple(writes), opid=opid):
            for w in writes:
                state[w].append(opid)

        for w in writes:
            expected[w].append(opid)
        e.push(op, const_vars=[vars_[r] for r in reads],
               mutable_vars=[vars_[w] for w in writes])
    e.wait_for_all()
    return state, expected


def test_stress_random_dag_matches_serial_and_the_jax_engine():
    """Each var's writer sequence equals push order (the reference's
    threaded_engine_test invariant), on the port's engine as on the JAX
    package's, for the same random stream."""
    got, want = _random_dag(eng.NativeEngine(num_workers=8), 7)
    jgot, jwant = _random_dag(jeng.NativeEngine(num_workers=8), 7)
    assert got == want == jgot == jwant


def test_naive_engine_inline():
    e = eng.NativeEngine(num_workers=2, engine_type="NaiveEngine")
    v = e.new_variable()
    out = []
    e.push(lambda: out.append(1), mutable_vars=[v])
    assert out == [1]  # ran synchronously inside push
    e.push_async(lambda done: (out.append(2), done()), const_vars=[v])
    assert out == [1, 2]


def test_profiler_chrome_trace(E):
    E.set_profiling(True)
    v = E.new_variable()
    E.push(lambda: time.sleep(0.01), mutable_vars=[v], name="slow_op")
    E.wait_for_all()
    trace = E.dump_profile()
    names = [ev["name"] for ev in trace["traceEvents"]]
    assert "slow_op" in names
    ev = trace["traceEvents"][names.index("slow_op")]
    assert ev["dur"] >= 5000  # >= 5 ms in microseconds


def test_python_fallback_engine():
    e = eng.PythonEngine()
    v = e.new_variable()
    out = []
    e.push(lambda: out.append(1), mutable_vars=[v])
    e.push_async(lambda done: (out.append(2), done()), const_vars=[v])
    e.wait_for_all()
    assert out == [1, 2]


def test_op_error_is_reported_and_the_engine_goes_on(E):
    seen = []
    prev = eng.set_error_handler(lambda name, exc: seen.append(
        (name, str(exc))))
    try:
        v = E.new_variable()

        def boom():
            raise ValueError("bad op")

        E.push(boom, mutable_vars=[v], name="boom")
        E.push(lambda: seen.append("after"), mutable_vars=[v])
        E.wait_for_all()
    finally:
        eng.set_error_handler(prev)
    assert seen == [("boom", "bad op"), "after"]


def test_fence_orders_after_async_op_and_host_callbacks():
    va = eng.new_variable()
    vb = eng.new_variable()
    events = []

    def slow_async(on_complete):
        def run():
            time.sleep(0.05)
            events.append("a")
            on_complete()
        threading.Thread(target=run, daemon=True).start()

    eng.push_async(slow_async, mutable_vars=[va])
    eng.push(lambda: events.append("b"), mutable_vars=[vb])
    f = eng.fence([va, vb], name="test_fence")
    assert f.wait(timeout=10.0) is f
    assert sorted(events) == ["a", "b"]
    assert f.done()
    eng.wait_for_all()


def test_fence_done_probe_and_timeout():
    f = eng.Fence(threading.Event(), 3)
    assert not f.done()
    with pytest.raises(MXNetError, match="3 var"):
        f.wait(timeout=0.05)
    assert eng.fence([]).wait(timeout=10.0).done()


def test_file_write_ordering_and_errors(tmp_path):
    """Writes to one path serialize in push order; a failure surfaces at
    the next wait on that path, once; a drained path's var is retired."""
    p = str(tmp_path / "blob")
    for i in range(4):
        eng.push_file_write(
            p, lambda i=i: open(p, "w").write(str(i)), wait=False)
    eng.wait_for_file(p)
    assert open(p).read() == "3"

    def boom():
        raise RuntimeError("disk full")

    eng.push_file_write(p, boom, wait=False)
    with pytest.raises(RuntimeError, match="disk full"):
        eng.wait_for_file(p)
    eng.push_file_write(p, lambda: open(p, "w").write("ok"), wait=True)
    assert open(p).read() == "ok"
    assert eng.os.path.abspath(p) not in eng._file_vars


def test_file_write_after_paths_orders_the_manifest(tmp_path):
    shard, manifest = str(tmp_path / "shard"), str(tmp_path / "manifest")
    order = []
    gate = threading.Event()

    def write_shard():
        gate.wait(10)
        order.append("shard")

    eng.push_file_write(shard, write_shard, wait=False)
    eng.push_file_write(manifest, lambda: order.append("manifest"),
                        wait=False, after_paths=[shard])
    time.sleep(0.05)
    assert order == []
    gate.set()
    eng.wait_for_all_files()
    assert order == ["shard", "manifest"]


def test_async_checkpoint_overlaps_training(tmp_path):
    """save_checkpoint(async_write=True) takes the parameters at the call
    and writes them through the engine while training goes on."""
    import mxnet_tpu_torch as mt

    rng = np.random.RandomState(0)
    x = rng.randn(64, 16).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.float32)
    it = mt.io.NDArrayIter(x, y, batch_size=16, label_name="softmax_label")
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = mt.sym.Activation(net, act_type="relu")
    net = mt.sym.FullyConnected(net, num_hidden=2, name="fc2")
    net = mt.sym.SoftmaxOutput(net, name="softmax")
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params()
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    mod.fit_step(next(iter(it)))
    snap = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
    prefix = str(tmp_path / "ck")
    mod.save_checkpoint(prefix, 1, async_write=True)
    it.reset()
    for b in it:
        mod.fit_step(b)
    adv = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    assert any(np.abs(snap[k] - adv[k]).max() > 1e-7 for k in snap)
    _, loaded, _ = mt.model.load_checkpoint(prefix, 1)
    for k in snap:
        assert np.array_equal(loaded[k].asnumpy(), snap[k]), k
    eng.wait_for_all()


def test_ctypes_trampoline_survives_many_ops(E):
    """10,000 ops through the one C trampoline, from several pushing
    threads at once, each var's order kept."""
    vs = [E.new_variable() for _ in range(4)]
    logs = [[] for _ in vs]

    def pusher(k):
        for i in range(2500):
            E.push(lambda k=k, i=i: logs[k].append(i), mutable_vars=[vs[k]])

    ts = [threading.Thread(target=pusher, args=(k,)) for k in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    E.wait_for_all()
    assert all(log == list(range(2500)) for log in logs)
    assert E.pending() == 0
    assert isinstance(E._lib, ctypes.CDLL)
