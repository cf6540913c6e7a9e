"""mxnet_tpu_torch's parameter server, ``parallel.dist`` and the dist
stores against the JAX package, on the CPU.

- The parameter server in one process (a server thread, client threads,
  real sockets on port 0): one counterpart of each of
  ``tests/test_dist_ps.py``'s eight tests, the sharding of a big key over
  two servers, and one test for each of the two reference bugs the port
  does not copy (``MXNET_TPU_IS_RECOVERY="0"`` read as true; a new store
  of a live rank answered "recovery").
- ``parallel.dist``: single-process without configuration, and the
  resource managers' rank and world as the JAX package reads them.
- Three multi-process tests (``tools/dist_run.py``: a server binds port 0
  and reports it, collective ranks meet at a ``file://`` rendezvous, every
  child is killed in ``finally``, each group under 60 s; the children
  import torch and the port only): two gloo ranks in closed form; the
  narrow LSTM LM over two ranks against the JAX package's one-process fit
  at the whole batch; a server with two workers, one killed and started
  again.
"""
import os
import pickle
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import kvstore_server as ps
from mxnet_tpu_torch.kvstore_server import KVStoreServer, PSClient
from mxnet_tpu_torch.parallel import dist
from mxnet_tpu_torch.tools import dist_lstm as dl
from mxnet_tpu_torch.tools import dist_run as dr

GROUP_S = 60


def _server(n_workers, sync_mode=True):
    """A server on a free port, serving from a thread; (server, address)."""
    srv = KVStoreServer(address=("127.0.0.1", 0), n_workers=n_workers,
                        sync_mode=sync_mode)
    srv.start_background()
    return srv, srv.address


def _join(threads, timeout=30):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive()


def test_ps_sync_closed_form():
    """Three workers push rank-scaled ones four times under the Test
    optimizer: the closed form exactly."""
    n, shape, rate, rounds = 3, (5, 7), 2.0, 4
    _, addr = _server(n)
    c0 = PSClient(addr)
    c0.set_optimizer(mt.optimizer.Test(rescale_grad=rate))
    c0.init(3, np.zeros(shape, np.float32))

    def worker(rank):
        c = c0 if rank == 0 else PSClient(addr)
        for _ in range(rounds):
            c.push(3, np.ones(shape, np.float32) * (rank + 1))

    _join([threading.Thread(target=worker, args=(r,)) for r in range(n)])
    want = rounds * rate * sum(r + 1 for r in range(n))
    np.testing.assert_array_equal(c0.pull(3), np.full(shape, want))
    c0.stop()


def test_ps_async_applies_immediately():
    _, addr = _server(2, sync_mode=False)
    c = PSClient(addr)
    c.set_optimizer(mt.optimizer.Test(rescale_grad=1.0))
    c.init("w", np.zeros((4,), np.float32))
    c.push("w", np.ones((4,), np.float32))
    np.testing.assert_array_equal(c.pull("w"), np.ones(4))
    c.stop()


def test_ps_barrier_and_default_assign():
    """A barrier releases both workers; without an optimizer a sync push
    stores the merged sum."""
    _, addr = _server(2)
    c1, c2 = PSClient(addr), PSClient(addr)
    c1.init("x", np.full((3,), 7.0, np.float32))
    passed = []
    _join([threading.Thread(target=lambda c=c: (c.barrier(),
                                                passed.append(1)))
           for c in (c1, c2)])
    assert len(passed) == 2
    _join([threading.Thread(target=lambda: c1.push(
               "x", np.ones(3, np.float32))),
           threading.Thread(target=lambda: c2.push(
               "x", 2 * np.ones(3, np.float32)))])
    np.testing.assert_array_equal(c1.pull("x"), np.full(3, 3.0))
    c1.stop()


def _wait_for(cond, what, timeout=10):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, what
        time.sleep(0.02)


def test_ps_liveness_registry():
    """A rank whose control connection drops is dead; its hello on a new
    connection is a recovery and clears it; a stale heartbeat counts as
    dead under a short timeout, one heartbeat revives it."""
    _, addr = _server(2)
    c0, c1 = PSClient(addr), PSClient(addr)
    assert c0.hello(0) == "welcome"
    assert c1.hello(1) == "welcome"
    assert c0.dead_nodes(timeout_sec=30) == []
    c1._ctrl.close()
    _wait_for(lambda: c0.dead_nodes(timeout_sec=30) == [1], "never dead")
    c1b = PSClient(addr)
    assert c1b.hello(1) == "recovery"
    assert c0.dead_nodes(timeout_sec=30) == []
    time.sleep(0.3)
    assert 0 in c0.dead_nodes(timeout_sec=0.1)
    c0.heartbeat(0)
    assert 0 not in c0.dead_nodes(timeout_sec=10)
    c0.stop()


def test_ps_sync_merge_dedupes_per_rank():
    """A rank's second push of a round replaces its first: a recovered
    worker is not counted twice, and its new value enters the merge."""
    _, addr = _server(2)
    c0 = PSClient(addr, rank=0)
    c0.init("w", np.zeros((3,), np.float32))
    dead = PSClient(addr, rank=1)
    threading.Thread(target=lambda: dead.push(
        "w", np.full((3,), 10.0, np.float32)), daemon=True).start()
    time.sleep(0.3)
    c1 = PSClient(addr, rank=1)
    t1 = threading.Thread(target=lambda: c1.push(
        "w", np.full((3,), 2.0, np.float32)))
    t1.start()
    time.sleep(0.2)
    c0.push("w", np.ones((3,), np.float32))
    t1.join(10)
    np.testing.assert_array_equal(c0.pull("w"), np.full(3, 3.0))
    c0.stop()


def test_ps_kvstore_worker_facade(monkeypatch):
    """create("dist_async") with a server URI is the parameter-server
    store: rank, workers, init, an optimizer shipped, push and pull."""
    _, (host, port) = _server(1, sync_mode=False)
    monkeypatch.setenv("MXNET_TPU_PS_URI", "%s:%d" % (host, port))
    monkeypatch.setenv("MXNET_TPU_NUM_WORKERS", "1")
    kv = mt.kvstore.create("dist_async")
    assert isinstance(kv, mt.kvstore.PSKVStore)
    assert kv.rank == 0 and kv.num_workers == 1
    kv.init(9, mt.nd.zeros((2, 2), "cpu"))
    kv.set_optimizer(mt.optimizer.Test(rescale_grad=1.0))
    kv.push(9, [mt.nd.ones((2, 2), "cpu"), mt.nd.ones((2, 2), "cpu")])
    out = mt.nd.zeros((2, 2), "cpu")
    kv.pull(9, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full((2, 2), 2.0))
    kv.stop_server()


def test_ps_rpc_errors_surface_at_the_next_sync_point(monkeypatch):
    """A push returns before its RPC runs (an engine op); a server's error
    on it surfaces at the next pull or barrier, and a pull of an unknown
    key raises there."""
    _, (host, port) = _server(1, sync_mode=False)
    monkeypatch.setenv("MXNET_TPU_PS_URI", "%s:%d" % (host, port))
    monkeypatch.setenv("MXNET_TPU_NUM_WORKERS", "1")
    kv = mt.kvstore.create("dist_async")
    kv.init(1, mt.nd.zeros((3,), "cpu"))
    out = mt.nd.zeros((3,), "cpu")
    with pytest.raises(mt.MXNetError, match="uninitialized key 5"):
        kv.pull(5, out=out)
    calls = []

    def failing(key, value):
        calls.append(key)
        raise OSError("wire cut")

    monkeypatch.setattr(kv._client, "push", failing)
    kv.push(1, mt.nd.ones((3,), "cpu"))  # returns: the RPC is queued
    with pytest.raises(OSError, match="wire cut"):
        kv.barrier()
    assert calls == [1]
    monkeypatch.undo()
    kv.pull(1, out=out)  # nothing pending any more
    np.testing.assert_array_equal(out.asnumpy(), np.zeros(3))
    kv.stop_server()


def test_wire_framing_roundtrip_edge_shapes():
    """send_msg / recv_msg: empty multi-dim arrays, a 0-d array, mixed
    control and array parts, types and shapes kept; the port's frames
    read as the JAX package's do (which sends a 0-d array as 1-d)."""
    from multiprocessing import Pipe

    from mxnet_tpu import kvstore_server as jps

    cases = [
        ("push", "k", np.arange(6, dtype=np.float32).reshape(2, 3)),
        ("ok", np.zeros((0, 3), np.float32)),
        ("ok", np.zeros((0,), np.int32)),
        ("mixed", np.zeros((), np.float32), "tail",
         np.arange(4, dtype=np.int64)),
        ("ctl-only", 42, {"nested": [1, 2]}),
    ]
    for send, recv, skip in ((ps.send_msg, ps.recv_msg, None),
                             (ps.send_msg, jps.recv_msg, None),
                             (jps.send_msg, ps.recv_msg, "mixed")):
        a, b = Pipe()
        cases = [c for c in cases if c[0] != skip]
        for msg in cases:
            send(a, *msg)
        for msg in cases:
            got = recv(b)
            assert len(got) == len(msg)
            for want, g in zip(msg, got):
                if isinstance(want, np.ndarray):
                    assert g.dtype == want.dtype and g.shape == want.shape
                    np.testing.assert_array_equal(g, want)
                else:
                    assert g == want


def test_ps_rpcs_carry_client_trace_context():
    """A worker's trace context rides the wire: the server's push and
    pull spans land in the client's trace; control traffic untraced."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.telemetry import context as tctx
    from mxnet_tpu_torch.telemetry import flight

    _, addr = _server(1, sync_mode=False)
    prev = telemetry.enabled_domains()
    telemetry.enable_spans("kvstore")
    flight.reset()
    try:
        c = PSClient(addr)
        c.set_optimizer(mt.optimizer.Test(rescale_grad=1.0))
        ctx = tctx.mint(request_id="step7")
        with tctx.use(ctx):
            c.init("w", np.zeros((4,), np.float32))
            c.push("w", np.ones((4,), np.float32))
            np.testing.assert_array_equal(c.pull("w"), np.ones(4))
        names = set()

        def seen():
            tree = flight.request_tree(ctx.trace_id)
            names.update(s["name"] for s in (tree or {}).get("spans", []))
            return {"kvstore.init", "kvstore.push", "kvstore.pull"} <= names

        _wait_for(seen, "spans %s" % names)
        assert not any("hello" in n or "heartbeat" in n for n in names)
        c.stop()
    finally:
        if prev:
            telemetry.enable_spans(prev)
        else:
            telemetry.disable_spans()
        flight.reset()


def test_ps_big_key_shards_over_two_servers(monkeypatch):
    """A key over the bound splits into one contiguous range a server;
    both sync-merge their range and the pull joins them in order."""
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "10")
    servers = [_server(2) for _ in range(2)]
    addrs = [a for _, a in servers]
    c0, c1 = PSClient(addrs, rank=0), PSClient(addrs, rank=1)
    c0.init("big", np.zeros(25, np.float32))
    c0.init("small", np.zeros(4, np.float32))
    vals = {r: np.arange(25, dtype=np.float32) * (r + 1) for r in (0, 1)}
    _join([threading.Thread(target=lambda c=c, r=r: c.push("big", vals[r]))
           for r, c in ((0, c0), (1, c1))])
    np.testing.assert_array_equal(c0.pull("big", size=25),
                                  vals[0] + vals[1])
    assert sorted(len(s.store) for s, _ in servers) == [1, 2]
    assert [s.store[("big", "part", i)].size
            for i, (s, _) in enumerate(servers)] == [13, 12]
    c0.stop()


def test_recovery_flag_zero_is_not_a_recovery(monkeypatch):
    """MXNET_TPU_IS_RECOVERY="0" (or "false") is false: the worker joins
    the startup barriers (the JAX package reads any value as true)."""
    srv, (host, port) = _server(1)
    monkeypatch.setenv("MXNET_TPU_PS_URI", "%s:%d" % (host, port))
    monkeypatch.setenv("MXNET_TPU_NUM_WORKERS", "1")
    for flag, want in (("0", False), ("false", False), ("", False),
                       ("1", True), ("true", True)):
        monkeypatch.setenv("MXNET_TPU_IS_RECOVERY", flag)
        kv = mt.kvstore.create("dist_sync")
        assert kv._recovery is want, flag
        kv.close()
    monkeypatch.setenv("MXNET_TPU_IS_RECOVERY", "0")
    kv = mt.kvstore.create("dist_sync")
    kv.stop_server()


def test_new_store_of_a_live_rank_is_welcome_not_recovery(monkeypatch):
    """A second store of a running job (the first still connected, or
    gone with a goodbye) is a fresh join: its hello is "welcome", so rank
    0 applies its mode and optimizer. Only a dropped connection makes a
    recovery."""
    srv, (host, port) = _server(1)
    monkeypatch.setenv("MXNET_TPU_PS_URI", "%s:%d" % (host, port))
    monkeypatch.setenv("MXNET_TPU_NUM_WORKERS", "1")
    monkeypatch.delenv("MXNET_TPU_IS_RECOVERY", raising=False)
    first = mt.kvstore.create("dist_sync")
    assert not first._recovery and srv.sync_mode
    second = mt.kvstore.create("dist_async")  # the first still connected
    assert not second._recovery and not srv.sync_mode
    second.close()
    third = mt.kvstore.create("dist_sync")  # after a goodbye
    assert not third._recovery and srv.sync_mode
    third.set_optimizer(mt.optimizer.SGD(learning_rate=0.5))
    assert isinstance(srv.updater.optimizer, mt.optimizer.SGD)
    # a dropped control connection: the rank's next hello is a recovery
    third._hb_stop.set()
    third._client._ctrl.close()
    _wait_for(lambda: srv._workers[0]["dead_since"] is not None, "drop")
    assert PSClient((host, port)).hello(0) == "recovery"
    first.stop_server()


def test_numpy_updater_runs_the_ports_optimizer_in_place():
    """The server's updater: the port's SGD with momentum on CPU tensors
    over the stored array, equal to the Updater on the same values."""
    opt = mt.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-3,
                           rescale_grad=0.5)
    up = ps._NumpyUpdater(pickle.loads(pickle.dumps(opt)))
    ref = mt.optimizer.get_updater(opt)
    rng = np.random.RandomState(0)
    w = rng.randn(6).astype(np.float32)
    wt = mt.nd.array(w, ctx="cpu")
    for _ in range(3):
        g = rng.randn(6).astype(np.float32)
        up(4, g, w)
        ref(4, mt.nd.array(g, ctx="cpu"), wt)
    np.testing.assert_array_equal(w, wt.asnumpy())


# --- parallel.dist ----------------------------------------------------------
def test_dist_single_process_without_configuration(monkeypatch):
    for k in ("MXNET_TPU_COORDINATOR", "MXNET_TPU_NUM_PROCS",
              "MXNET_TPU_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SLURM_PROCID", "3")  # alone: no coordinator
    monkeypatch.setattr(dist, "_initialized", False)
    dist.init()
    assert (dist.rank(), dist.size(), dist.is_recovery(),
            dist.num_dead_nodes()) == (0, 1, False, 0)
    dist.barrier()
    assert not dist.is_distributed() and dist.backend() is None
    kv = mt.kvstore.create("dist_sync")
    assert (kv.rank, kv.num_workers) == (0, 1)
    monkeypatch.setattr(dist, "_initialized", False)


@pytest.mark.parametrize("env", [
    {"OMPI_COMM_WORLD_RANK": "2", "OMPI_COMM_WORLD_SIZE": "4"},
    {"PMI_RANK": "1", "PMI_SIZE": "3"},
    {"SLURM_PROCID": "5", "SLURM_NTASKS": "8"},
    {"SGE_TASK_ID": "7", "SGE_TASK_FIRST": "3", "SGE_TASK_STEPSIZE": "2",
     "SGE_TASK_LAST": "9"},
    {}])
def test_resource_manager_rank_matches_jax(env, monkeypatch):
    from mxnet_tpu.parallel import dist as jdist

    for k in ("OMPI_COMM_WORLD_RANK", "PMI_RANK", "SLURM_PROCID",
              "SGE_TASK_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dist._resource_manager_rank() == jdist._resource_manager_rank()


# --- several processes ------------------------------------------------------
def test_collective_ranks_closed_form(tmp_path):
    """Two gloo ranks: one group, an all-gather in rank order, and the
    collective dist_sync / dist_async stores in closed form, exactly."""
    g = dr.Group(str(tmp_path))
    try:
        g.start_workers(dr.module_cmd("mxnet_tpu_torch.tools.dist_collective",
                                      "--device", "cpu"), 2)
        outs = g.wait(GROUP_S)
    finally:
        g.stop()
    res = [dr.last_json(outs[r]) for r in (0, 1)]
    assert [r["rank"] for r in res] == [0, 1]
    for r in res:
        assert r["ok"] and r["size"] == 2 and r["backend"] == "gloo"
        assert r["allgather"] == [1.0, 2.0] and r["exact_checks"] == 8


def _jax_fit(cfg, seed):
    """The JAX package's one-process fit of the LSTM LM at the whole
    batch: (states before and after each batch, the label probabilities
    of each batch)."""
    sym = mx.models.get_symbol(
        "lstm-lm", num_classes=cfg["vocab"], seq_len=cfg["seq"],
        num_embed=cfg["embed"], num_hidden=cfg["hidden"],
        num_layers=cfg["layers"], fused=True)
    from mxnet_tpu_torch.tools.lstm_lm import lstm_data

    x, y = lstm_data(cfg, cfg["batch"], cfg["batches"], seed + 1)
    it = mx.io.NDArrayIter(x, y, batch_size=cfg["batch"])
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    np.random.seed(seed)
    init = mx.initializer.Xavier()
    mod.init_params(init)

    def params():
        return {n: v.asnumpy().copy() for n, v in mod.get_params()[0].items()}

    states, probs = [params()], []

    def record(param):
        states.append(params())
        out = mod.get_outputs()[0].asnumpy()
        label = y[(len(states) - 2) * cfg["batch"]:][:cfg["batch"]]
        probs.append(out[np.arange(out.shape[0]),
                         label.reshape(-1).astype(np.int64)])

    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=(("learning_rate", cfg["lr"]),
                              ("momentum", cfg["momentum"])),
            initializer=init, eval_metric=mx.metric.Perplexity(None),
            batch_end_callback=record)
    return states, probs


def test_lstm_lm_over_two_ranks_matches_jax_one_process(tmp_path):
    """The narrow LSTM LM over two gloo ranks (4 rows of every batch of 8
    each, dist_sync) against the JAX package's one-process fit at batch 8:
    the same first weights, each batch's parameters within 1e-5, the
    joined perplexity within 1e-6, both ranks bit for bit."""
    import json

    cfg = dict(dl.DIST_LSTM, vocab=50, embed=16, hidden=16, seq=5, batch=8,
               batches=3)
    out = str(tmp_path)
    g = dr.Group(out)
    try:
        g.start_workers(dr.module_cmd(
            "mxnet_tpu_torch.tools.dist_lstm", "--out", out, "--cfg",
            json.dumps(cfg), "--device", "cpu", "--backend", "gloo",
            "--states"), 2)
        outs = g.wait(GROUP_S)
    finally:
        g.stop()
    res = [dr.last_json(outs[r]) for r in (0, 1)]
    assert all(r["workers"] == 2 and r["batch"] == 4 for r in res)
    want, want_probs = _jax_fit(cfg, dl.SEED)
    got = [dict(np.load(os.path.join(out, "state%d.npz" % b)))
           for b in range(cfg["batches"] + 1)]
    for n in want[0]:
        np.testing.assert_array_equal(got[0][n], want[0][n])
    for g_, w in zip(got[1:], want[1:]):
        for n in w:
            np.testing.assert_allclose(g_[n], w[n], rtol=1e-5,
                                       atol=1e-5 * np.abs(w[n]).max(),
                                       err_msg=n)
    finals = [np.load(os.path.join(out, "final%d.npz" % r)) for r in (0, 1)]
    for n in want[0]:
        np.testing.assert_array_equal(finals[0][n], finals[1][n])
    ppl = dl.combined_perplexity([np.load(os.path.join(out, "probs%d.npy"
                                                       % r)) for r in (0, 1)])
    np.testing.assert_allclose(ppl, dl.combined_perplexity([want_probs]),
                               rtol=1e-6)


def test_ps_worker_killed_and_restarted(tmp_path):
    """One server, two sync workers: rank 1 dies after round 2, rank 0
    sees one dead node while its merge waits, rank 1 started again is a
    recovery and both end on the closed form."""
    env = dict(os.environ, MXNET_TPU_VICTIM_RANK="1",
               MXNET_TPU_KILL_AFTER_ROUND="2", MXNET_TPU_PS_HEARTBEAT="0.5")
    g = dr.Group(str(tmp_path), env=env)
    cmd = dr.module_cmd("mxnet_tpu_torch.tools.dist_recovery_kvstore",
                        "--device", "cpu")
    deadline = time.time() + GROUP_S  # the whole group's limit

    def left():
        return max(deadline - time.time(), 0.1)

    try:
        g.start_servers(cmd, 1, 2, left())
        g.start_workers(cmd, 2)
        g.wait(left(), ranks=[1], expect_rc=42)
        assert "dying after round 2" in g.log("worker1")
        _wait_for(lambda: "SAW_DEAD=1" in g.log("worker0"), "no SAW_DEAD",
                  timeout=left())
        g.start_worker(cmd, 1, 2)
        outs = g.wait(left())
        g.wait_servers(min(10, left()))
    finally:
        g.stop()
    res = {r: dr.last_json(o) for r, o in outs.items()}
    assert res[1]["recovered"] and not res[0]["recovered"]
    assert res[0]["saw_dead"]
    assert res[0]["value"] == res[1]["value"] == 6 * 3.0
    assert "REJOINED as recovery" in g.log("worker1-restart")
