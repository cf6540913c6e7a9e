"""The port's persistent program cache (``mxnet_tpu_torch.progcache``).

The counterparts of ``tests/test_progcache.py`` on the port: every damaged
or skewed entry falls back to a fresh build with the same outputs bit for
bit; the manifest is advisory and rebuilt from a scan; the LRU byte budget
evicts the oldest; ladders persist; bytes split by kind. Beside them: the
exported narrow LM ``Predictor`` against a fresh bind bit for bit, the
quantized predictor's entries, the keys against the JAX package's
fingerprint discipline, and a warm restart in a subprocess."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import predict, progcache
from mxnet_tpu_torch.analysis import compile_witness as witness
from mxnet_tpu_torch.serving.bucket_cache import BucketCache

IN_DIM, HIDDEN = 4, 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_LM = {"vocab": 97, "d_model": 32, "heads": 4, "kv_heads": 2, "ffn": 64,
           "layers": 2}


def _model(seed=0):
    data = mt.sym.Variable("data")
    fc = mt.sym.FullyConnected(data=data, num_hidden=HIDDEN, name="fc")
    sym = mt.sym.SoftmaxOutput(data=fc, name="softmax")
    rng = np.random.RandomState(seed)
    params = {"fc_weight": rng.uniform(-0.1, 0.1, (HIDDEN, IN_DIM))
              .astype(np.float32),
              "fc_bias": np.zeros((HIDDEN,), np.float32)}
    return sym, params


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    d = str(tmp_path / "progcache")
    monkeypatch.delenv("MXNET_PROGCACHE", raising=False)
    monkeypatch.setenv("MXNET_PROGCACHE_DIR", d)
    progcache.reset_stats()
    return d


def _predictor(sym, params, batch=2):
    return predict.Predictor(sym.tojson(), params, {"data": (batch, IN_DIM)},
                             device="cpu")


def _entry_files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".prog"))


def _x(batch=2, seed=5):
    return np.random.RandomState(seed).uniform(-1, 1, (batch, IN_DIM)) \
        .astype(np.float32)


def _out(p, x):
    return p.forward(data=x)[0].asnumpy()


def test_store_load_roundtrip_bitwise(cache_dir):
    sym, params = _model()
    loads0 = predict.disk_load_count()
    p1 = _predictor(sym, params)
    assert p1.progcache_source == "compile"
    assert progcache.stats()["stores"] == 1
    assert len(_entry_files(cache_dir)) == 1
    p2 = _predictor(sym, params)
    assert p2.progcache_source == "disk"
    assert predict.disk_load_count() == loads0 + 1
    assert np.array_equal(_out(p1, _x()), _out(p2, _x()))
    s = progcache.stats()
    assert s["hits"] == 1 and s["misses"] == 1 and s["fallbacks"] == 0


def test_disabled_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv("MXNET_PROGCACHE", raising=False)
    monkeypatch.delenv("MXNET_PROGCACHE_DIR", raising=False)
    assert not progcache.enabled()
    sym, params = _model()
    p = _predictor(sym, params)
    assert not hasattr(p, "_progcache_model_fp")
    assert p._program is None and p.progcache_source == "compile"


def test_default_dir_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("MXNET_PROGCACHE_DIR", raising=False)
    monkeypatch.setenv("MXNET_PROGCACHE", "1")
    assert progcache.cache_dir().endswith(
        os.path.join(".cache", "mxnet_tpu_torch", "progcache"))


def test_kill_switch_wins_over_dir(cache_dir, monkeypatch):
    monkeypatch.setenv("MXNET_PROGCACHE", "0")
    assert not progcache.enabled()
    sym, params = _model()
    _predictor(sym, params)
    assert not os.path.exists(cache_dir)


def _damage(cache_dir, fn):
    path = os.path.join(cache_dir, _entry_files(cache_dir)[0])
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(fn(blob))


def test_truncated_entry_falls_back_bitwise(cache_dir):
    sym, params = _model()
    want = _out(_predictor(sym, params), _x())
    _damage(cache_dir, lambda b: b[:len(b) // 2])
    p = _predictor(sym, params)
    assert p.progcache_source == "compile"
    assert np.array_equal(_out(p, _x()), want)
    assert progcache.stats()["fallbacks"] == 1
    # the fallback stored a good entry again
    assert _predictor(sym, params).progcache_source == "disk"


def test_payload_crc_mismatch_falls_back_bitwise(cache_dir):
    sym, params = _model()
    want = _out(_predictor(sym, params), _x())
    _damage(cache_dir, lambda b: b[:-1] + bytes([b[-1] ^ 0xFF]))
    p = _predictor(sym, params)
    assert p.progcache_source == "compile"
    assert np.array_equal(_out(p, _x()), want)
    assert progcache.stats()["fallbacks"] == 1


def test_unloadable_payload_falls_back(cache_dir):
    """A payload with a good CRC that is not a saved program: the load's
    own failure is the counted fallback."""
    sym, params = _model()
    want = _out(_predictor(sym, params), _x())
    key = _entry_files(cache_dir)[0][:-len(".prog")]
    meta = dict(progcache._runtime_meta(), key=key, kind="predictor",
                zeros={})
    progcache._atomic_write_bytes(
        os.path.join(cache_dir, key + ".prog"),
        progcache._pack_entry(meta, b"not a program"))
    p = _predictor(sym, params)
    assert p.progcache_source == "compile"
    assert np.array_equal(_out(p, _x()), want)
    assert progcache.stats()["fallbacks"] == 1


def test_version_skew_falls_back_bitwise(cache_dir, monkeypatch):
    sym, params = _model()
    want = _out(_predictor(sym, params), _x())
    real = progcache._runtime_meta()
    with monkeypatch.context() as mp:
        # the key hashes the runtime too, so a skewed store lands under
        # another key; write one under today's key by hand
        mp.setattr(progcache, "_runtime_meta",
                   lambda: dict(real, torch="0.0.0"))
        key = _predictor(sym, params)._cache_key()
    assert key in {f[:-5] for f in _entry_files(cache_dir)}
    today = [f for f in _entry_files(cache_dir) if f[:-5] != key][0]
    os.replace(os.path.join(cache_dir, key + ".prog"),
               os.path.join(cache_dir, today))
    p = _predictor(sym, params)
    assert p.progcache_source == "compile"
    assert np.array_equal(_out(p, _x()), want)
    assert progcache.stats()["fallbacks"] == 1


def test_meta_block_skew_is_a_fallback(cache_dir):
    sym, params = _model()
    _predictor(sym, params)
    entry = os.path.join(cache_dir, _entry_files(cache_dir)[0])
    with open(entry, "rb") as f:
        blob = f.read()
    meta, payload = progcache._unpack_entry(blob)
    meta["device_kind"] = "another card"
    with open(entry, "wb") as f:
        f.write(progcache._pack_entry(meta, payload))
    assert progcache.load(os.path.basename(entry)[:-len(".prog")]) is None
    assert progcache.stats()["fallbacks"] == 1


def test_stale_fingerprint_after_param_change(cache_dir):
    sym, params = _model()
    p1 = _predictor(sym, params)
    params2 = dict(params)
    params2["fc_weight"] = params["fc_weight"] + np.float32(1e-3)
    p2 = _predictor(sym, params2)
    assert p2.progcache_source == "compile"
    assert p1._progcache_model_fp != p2._progcache_model_fp
    assert not np.array_equal(_out(p1, _x()), _out(p2, _x()))
    p3 = _predictor(sym, params2, batch=3)
    assert p3.progcache_source == "compile"


def test_fingerprint_hashes_bytes_as_the_jax_packages_does():
    """The same weights give the same fingerprint from numpy, tensors or
    NDArrays; a change of one bit gives another."""
    sym, params = _model()
    a = progcache.model_fingerprint(sym, params, {})
    b = progcache.model_fingerprint(
        sym, {n: mt.nd.array(v, ctx=mt.cpu()) for n, v in params.items()},
        {})
    flip = dict(params)
    w = flip["fc_weight"].copy()
    w.view(np.uint32)[0, 0] ^= 1
    flip["fc_weight"] = w
    assert a == b != progcache.model_fingerprint(sym, flip, {})


def test_manifest_corruption_rebuilds_from_scan(cache_dir):
    sym, params = _model()
    _predictor(sym, params)
    man = os.path.join(cache_dir, progcache.MANIFEST)
    with open(man, "w") as f:
        f.write("{not json")
    p = _predictor(sym, params)
    assert p.progcache_source == "disk"
    assert progcache.bytes_in_use() > 0


def test_manifest_crc_mismatch_rebuilds(cache_dir):
    sym, params = _model()
    _predictor(sym, params)
    man = os.path.join(cache_dir, progcache.MANIFEST)
    with open(man) as f:
        m = json.load(f)
    m["clock"] += 7  # tamper without recomputing the crc
    with open(man, "w") as f:
        f.write(json.dumps(m))
    assert _predictor(sym, params).progcache_source == "disk"


def test_lru_byte_budget_evicts_oldest(cache_dir, monkeypatch):
    sym, params = _model()
    p = _predictor(sym, params, batch=1)
    size = os.path.getsize(
        os.path.join(cache_dir, _entry_files(cache_dir)[0]))
    monkeypatch.setenv("MXNET_PROGCACHE_BYTES", str(int(size * 2.5)))
    p.reshape({"data": (2, IN_DIM)})
    p.reshape({"data": (3, IN_DIM)})
    assert progcache.stats()["evictions"] >= 1
    assert progcache.bytes_in_use() <= int(size * 2.5)
    assert p.reshape({"data": (3, IN_DIM)}).progcache_source == "disk"
    assert p.reshape({"data": (1, IN_DIM)}).progcache_source == "compile"


def test_atomic_commits_leave_no_tmp(cache_dir):
    sym, params = _model()
    _predictor(sym, params)
    assert not [f for f in os.listdir(cache_dir) if f.endswith(".tmp")]


def test_bucket_cache_stats_split_and_warm_restart(cache_dir):
    sym, params = _model()
    base = _predictor(sym, params, batch=1)
    cache = BucketCache(base, (1, 2, 4))
    cache.warm()
    s = cache.stats()
    assert s["compiles"] == 2 and s["disk_hits"] == 0
    assert s["cache_hits"] == s["hits"]
    base2 = _predictor(sym, params, batch=1)
    cache2 = BucketCache(base2, (1, 2, 4))
    cache2.warm()
    s2 = cache2.stats()
    assert s2["compiles"] == 0 and s2["disk_hits"] == 2
    x = _x(2, 6)
    assert np.array_equal(_out(cache.get(2), x), _out(cache2.get(2), x))


def test_bucket_cache_split_from_the_witness(cache_dir):
    prev = witness.enable(True)
    witness.reset()
    try:
        sym, params = _model()
        base = _predictor(sym, params, batch=1)
        BucketCache(base, (1, 2)).warm()
        base2 = _predictor(sym, params, batch=1)
        cache2 = BucketCache(base2, (1, 2))
        cache2.warm()
        assert cache2.stats()["compiles"] == 0
        assert cache2.stats()["disk_hits"] == 1
        rep = witness.compile_witness_report()
        assert rep["compiles"] == {"predictor": 2}
        assert rep["disk_loads"] == {"predictor": 2}
    finally:
        witness.reset()
        witness.enable(prev)


def test_ladder_persistence_roundtrip(cache_dir):
    sym, params = _model()
    base = _predictor(sym, params, batch=1)
    cache = BucketCache(base, (1, 4))
    cache.warm()
    cache.prepare(3)
    cache.set_ladder([3, 4])
    fp = base._progcache_model_fp
    assert progcache.load_ladder(fp) == [3, 4]
    base2 = _predictor(sym, params, batch=1)
    cache2 = BucketCache(base2, (1, 4))
    assert cache2.restore_ladder() is True
    assert cache2.buckets == [3, 4]
    cache2.warm()
    assert cache2.stats()["compiles"] == 0


def test_restore_ladder_rejects_mismatched_max_and_budget(cache_dir):
    sym, params = _model()
    base = _predictor(sym, params, batch=1)
    fp = progcache.model_fingerprint(
        base._symbol, base._arg_params, base._aux_params)
    progcache.save_ladder(fp, [2, 16])
    cache = BucketCache(base, (1, 4))
    assert cache.restore_ladder() is False
    assert cache.buckets == [1, 4]
    progcache.save_ladder(fp, [1, 2, 3, 4])
    assert cache.restore_ladder(budget=2) is False
    assert cache.restore_ladder(budget=4) is True


def test_restore_ladder_without_the_cache_is_false(monkeypatch):
    monkeypatch.delenv("MXNET_PROGCACHE", raising=False)
    monkeypatch.delenv("MXNET_PROGCACHE_DIR", raising=False)
    sym, params = _model()
    assert BucketCache(_predictor(sym, params, 1), (1, 4)) \
        .restore_ladder() is False


def test_telemetry_counters_exported(cache_dir):
    sym, params = _model()
    _predictor(sym, params)
    _predictor(sym, params)
    lines = {line.split()[0] for line in
             mt.telemetry.registry.exposition().splitlines()
             if line and not line.startswith("#")}
    for name in ("progcache_hits", "progcache_misses",
                 "progcache_fallbacks", "progcache_bytes"):
        assert name in lines, name


def test_bytes_by_kind_splits_and_survives_manifest_rebuild(cache_dir):
    assert progcache.store("kindtest_pred", b"p" * 300, kind="predictor")
    assert progcache.store("kindtest_quant", b"q" * 200, kind="quant")
    assert progcache.store("kindtest_legacy", b"x" * 100)
    bk = progcache.bytes_by_kind()
    assert bk["predictor"] > 300 and bk["quant"] > 200 and bk[""] > 100
    assert sum(bk.values()) == progcache.bytes_in_use()
    lines = {line.split()[0] for line in
             mt.telemetry.registry.exposition().splitlines()
             if line and not line.startswith("#")}
    assert "progcache_bytes_kind_predictor" in lines
    assert "progcache_bytes_kind_quant" in lines
    os.remove(os.path.join(cache_dir, progcache.MANIFEST))
    assert progcache.bytes_by_kind() == bk
    meta, payload = progcache.load("kindtest_quant")
    assert payload == b"q" * 200 and meta["kind"] == "quant"


def test_quantized_predictor_entries(cache_dir):
    sym, params = _model()
    base = _predictor(sym, params, batch=2)
    q1 = base.quantize("int8")
    assert q1.progcache_source == "compile"
    q2 = _predictor(sym, params, batch=2).quantize("int8")
    assert q2.progcache_source == "disk"
    assert np.array_equal(_out(q1, _x()), _out(q2, _x()))
    assert progcache.bytes_by_kind()["quant"] > 0
    # another weight type is another program
    assert base.quantize("fp8_e4m3").progcache_source == "compile"


def _lm_predictor(bt, device="cpu", _json=[]):
    """The narrow LM bound at ``bt``; one symbol JSON for the process (a
    second build names its nodes anew, and the fingerprint hashes the
    JSON)."""
    from mxnet_tpu_torch.tools.lm import lm_arg_params, lm_predict_symbol

    if not _json:
        _json.append(lm_predict_symbol(TINY_LM).tojson())
    return predict.Predictor(
        _json[0], lm_arg_params(TINY_LM, 0),
        {"data": bt, "softmax_label": bt}, device=device)


def test_exported_lm_predictor_equals_a_fresh_bind(cache_dir, monkeypatch):
    """The narrow GQA LM: the exported program (its flash forward the
    custom op) against the bind straight from the symbol, bit for bit."""
    bt = (2, 8)
    ids = np.random.RandomState(3).randint(0, 97, bt).astype(np.float32)
    feed = {"data": ids, "softmax_label": np.zeros(bt, np.float32)}
    fresh_store = _lm_predictor(bt)
    loaded = _lm_predictor(bt)
    assert (fresh_store.progcache_source, loaded.progcache_source) == \
        ("compile", "disk")
    targets = {str(n.target) for n in
               loaded._program.graph.nodes if n.op == "call_function"}
    assert "mxtt.flash_attention_fwd.default" in targets
    monkeypatch.setenv("MXNET_PROGCACHE", "0")
    plain = _lm_predictor(bt)
    assert plain._program is None
    want = plain.forward(**feed)[0].asnumpy()
    assert np.array_equal(fresh_store.forward(**feed)[0].asnumpy(), want)
    assert np.array_equal(loaded.forward(**feed)[0].asnumpy(), want)


def test_warm_restart_in_a_subprocess(tmp_path):
    """Two processes on one cache: the first serves, retunes (the tuner
    adds a rung) and saves; the second adopts the tuned ladder and
    disk-loads every bucket, with no fresh trace and the same outputs."""
    env = dict(os.environ, MXNET_PROGCACHE_DIR=str(tmp_path / "cache"),
               PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    env.pop("MXNET_PROGCACHE", None)
    conf = json.dumps({"lm": TINY_LM, "engine": {"restart_seq": 8}})
    recs = {}
    for role in ("first", "second"):
        out = str(tmp_path / (role + ".json"))
        subprocess.run(
            [sys.executable, "-m", "mxnet_tpu_torch.tools.engine_phase",
             "restart", role, out, "--device", "cpu", "--config", conf],
            cwd=ROOT, env=env, check=True, timeout=240,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        with open(out) as f:
            recs[role] = json.load(f)
    first, second = recs["first"], recs["second"]
    assert first["ladder"] == [1, 2, 4] and first["disk_loads"] == 0
    assert second["ladder_at_start"] == first["ladder"]
    assert second["disk_loads"] == len(first["ladder"])
    assert second["binds"] == 0 and second["compiles"] == 0
    assert second["engine"] == "NativeEngine"
    assert first["digests"] == second["digests"]
    assert len(first["digests"]) == 9
    assert second["truncated"] == {"bucket": 4, "source": "compile",
                                   "fallbacks": 1, "same_outputs": True}
