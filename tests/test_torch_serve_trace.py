"""The serve and train paths' spans and gauges in mxnet_tpu_torch against
mxnet_tpu.

Both decode schedulers get the same greedy traffic (each request with a
trace context of its own package) and the same weights, written by the
JAX package's ``interop.save_params`` and read by the port's: the small
LM of ``test_torch_decode.py`` (L 2, d 64, H 4, Hkv 2, V 64). Three arms:
unpaged with admissions mid-flight, paged with a shared prefix and a
copy-on-write fork, and speculative (int8 draft, k = 4). Exact: the
streams; each (domain, span name)'s count, engine spans included; one
``serving.queued``, ``serving.dispatch`` and ``decode.prefill`` a request;
``decode.step`` spans equal to each scheduler's own ``steps``; every
stream's trace id on its queued span and in the ``trace_ids`` of each
step it shared; the final values of the scheduler's counters and gauges
and the latency histogram's count. Then: spans off records nothing and
changes no token; a deadline miss writes one flight bundle in both; a
second scheduler's gauges start from its own values; ``Module.fit``'s
executor spans and the train-bytes gauges as the reference records
them. Each test runs on fresh registries with spans off around it
(``test_torch_telemetry.py``'s fixture).
"""
import collections
import os

import numpy as np
import pytest

from mxnet_tpu import interop as jinterop
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.serving import generate as jgen
from mxnet_tpu.telemetry import context as jctx
from mxnet_tpu.telemetry import flight as jflight
from mxnet_tpu_torch import interop as tinterop
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.serving import generate as tgen
from mxnet_tpu_torch.telemetry import context as tctx
from mxnet_tpu_torch.telemetry import flight as tflight

from test_torch_decode import H, HKV, _lm_params
from test_torch_telemetry import clean_telemetry, fresh_registries

JAX = (jgen, jtel, jctx, jflight)
TORCH = (tgen, ttel, tctx, tflight)
# the scheduler's counters and gauges (reference scheduler.py:228-262)
METRICS = ("decode_tokens_total", "decode_batch_occupancy_pct", "kv_bytes",
           "kv_bytes{dtype=", "kv_blocks_free{", "kv_blocks_total{",
           "decode_prefix_hits_total", "decode_prefix_tokens_saved_total",
           "decode_spec_accept_rate", "decode_tokens_per_step",
           "serving_request_latency_ms_count")
# arm -> (prompts, scheduler knobs)
ARMS = {
    "unpaged": ([[3, 7, 1, 9, 4], [5, 2, 8], [9, 4, 1, 2, 11, 6],
                 [1, 2, 3, 4, 5, 6, 7], [8, 8]], {}),
    "paged_prefix": ([[3, 7, 1, 9, 4, 2], [3, 7, 1, 9, 4, 2, 5, 8],
                      [5, 2, 8]], {"paged": True}),
    "spec": ([[3, 7, 1, 9, 4], [5, 2, 8], [9, 4, 1, 2, 11, 6]],
             {"spec": True, "spec_draft": "int8", "spec_tokens": 4}),
}


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_FLIGHT_DIR", str(tmp_path / "flight"))
    fresh_registries(monkeypatch)
    clean_telemetry()
    yield
    clean_telemetry()


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(reference model, port model): the JAX package writes the weights
    as a reference .params blob, the port reads it back."""
    params = _lm_params()
    path = str(tmp_path_factory.mktemp("weights") / "lm.params")
    jinterop.save_params(path, params)
    loaded = {k: v.asnumpy() for k, v in tinterop.load_params(path).items()}
    assert sorted(loaded) == sorted(params)
    jm = jgen.DecodeModel.from_arg_params(
        params, jgen.DecodeSpec(num_heads=H, num_kv_heads=HKV))
    tm = tgen.DecodeModel.from_arg_params(
        loaded, tgen.DecodeSpec(num_heads=H, num_kv_heads=HKV),
        device="cpu")
    return jm, tm


def _config(gen, **kw):
    cfg = dict(slots=3, max_context=24, prefill_buckets=(4, 8),
               max_new_tokens=6, block_tokens=4, num_blocks=0,
               prefix_share=True, eos_id=None, capture=False,
               quant_weights="", kv_dtype="f32", paged=False, spec=False)
    cfg.update(kw)
    return gen.GenerateConfig(num_heads=H, num_kv_heads=HKV, **cfg)


def _serve(pkg, model, prompts, spans="all", timeouts=None, **kw):
    """Serve ``prompts`` with a fresh trace context each; returns the
    streams' tokens and finish reasons or error codes, the scheduler's
    steps, the events recorded, the registry's sample lines and the
    traces."""
    gen, tel, ctx, _flight = pkg
    sched = gen.DecodeScheduler(model, _config(gen, **kw))
    if spans:
        tel.enable_spans(spans)
    sched.start()
    traces = [ctx.mint(request_id="req%d" % i) for i in range(len(prompts))]
    try:
        streams = [sched.submit(p, trace=tr,
                                timeout_ms=(timeouts or {}).get(i))
                   for i, (p, tr) in enumerate(zip(prompts, traces))]
        out = []
        for s in streams:
            try:
                out.append(s.tokens(timeout=120))
            except Exception as e:      # a stream that failed: its code
                out.append(getattr(e, "code", repr(e)))
        reasons = [s.finish_reason for s in streams]
        stats = sched.stats()
    finally:
        sched.stop()
    tel.disable_spans()
    events = tel.drain_events()
    samples = [ln for ln in tel.registry.exposition().splitlines()
               if not ln.startswith("#")]
    return {"tokens": out, "reasons": reasons, "steps": sched.steps,
            "events": events, "samples": samples, "traces": traces,
            "stats": stats}


def _metrics(samples):
    return sorted(ln for ln in samples if ln.startswith(METRICS))


def _fan_out(run, prompts, max_new):
    """Each stream's trace id on its own queued span and in the trace ids
    of every step it shared: one a token after its first."""
    serving = [e for e in run["events"] if e[2] == "serving"]
    queued = [e[5]["trace_id"] for e in serving if e[1] == "serving.queued"]
    shared = collections.Counter(
        tid for e in serving if e[1] == "decode.step"
        for tid in e[5]["trace_ids"])
    steps = [e for e in serving if e[1] == "decode.step"]
    for tr in run["traces"]:
        assert queued.count(tr.trace_id) == 1
        assert shared[tr.trace_id] == max_new - 1
    # a step's trace ids are the streams co-resident in it
    assert max(len(e[5]["trace_ids"]) for e in steps) == min(3, len(prompts))
    return sorted(shared.values())


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_spans_and_gauges_match_the_reference(arm, models):
    prompts, kw = ARMS[arm]
    runs = [_serve(pkg, m, prompts, **kw) for pkg, m in zip((JAX, TORCH),
                                                           models)]
    want, got = runs
    assert got["tokens"] == want["tokens"]
    assert got["reasons"] == ["max_tokens"] * len(prompts)
    count = [collections.Counter((e[2], e[1]) for e in r["events"])
             for r in runs]
    assert count[1] == count[0]
    n = len(prompts)
    for r, c in zip(runs, count):
        assert c[("serving", "serving.queued")] == n
        assert c[("serving", "serving.dispatch")] == n
        assert c[("serving", "decode.prefill")] == n
        assert c[("serving", "decode.step")] == r["steps"] > 0
        assert c[("engine", "decode.step")] == r["steps"]
    assert _metrics(got["samples"]) == _metrics(want["samples"])
    assert "serving_request_latency_ms_count %d" % n in got["samples"]
    st = got["stats"]
    values = dict(ln.rsplit(" ", 1) for ln in got["samples"])
    assert float(values["kv_bytes"]) == st["kv_bytes"]
    assert float(values["decode_tokens_total"]) == sum(
        len(t) for t in got["tokens"])
    assert float(values["decode_spec_accept_rate"]) == \
        st["decode_spec_accept_rate"]
    assert float(values["decode_tokens_per_step"]) == \
        st["decode_tokens_per_step"]
    if arm == "spec":
        assert count[1][("serving", "decode.draft")] == got["steps"]
        assert count[1][("serving", "decode.verify")] == got["steps"]
        assert st["decode_tokens_per_step"] > 1
    else:
        assert _fan_out(got, prompts, 6) == _fan_out(want, prompts, 6)
    if arm == "paged_prefix":
        assert count[1][("serving", "decode.cow_fork")] == 1
        assert st["prefix_hits"] == 1
        (prefill,) = [e for e in got["events"]
                      if e[2] == "serving" and e[1] == "decode.prefill"
                      and e[5]["reused"]]
        assert prefill[5]["reused"] == st["prefix_tokens_saved"]


def test_flight_trees_hold_each_requests_spans_as_the_reference(models):
    prompts, kw = ARMS["unpaged"]
    trees = []
    for pkg, m in zip((JAX, TORCH), models):
        run = _serve(pkg, m, prompts, **kw)
        flight = pkg[3]
        per = []
        for tr in run["traces"]:
            tree = flight.request_tree(tr.request_id)
            names = collections.Counter()

            def walk(nodes):
                for n in nodes:
                    names[n["name"]] += 1
                    walk(n["children"])

            walk(tree["spans"])
            per.append((tree["trace_id"] == tr.trace_id, tree["ok"],
                        tree["kind"], sorted(names.items())))
        trees.append(per)
    assert trees[1] == trees[0]
    assert trees[1][0][3] == [("decode.prefill", 1), ("decode.step", 5),
                              ("serving.dispatch", 1),
                              ("serving.queued", 1)]


def test_spans_off_records_nothing_and_changes_no_token(models):
    prompts, kw = ARMS["unpaged"]
    on = _serve(TORCH, models[1], prompts, **kw)
    off = _serve(TORCH, models[1], prompts, spans=None, **kw)
    assert off["tokens"] == on["tokens"]
    assert off["events"] == [] and on["events"]
    assert off["steps"] == on["steps"]
    assert tflight.summary()["live_traces"] == 0


def test_a_deadline_miss_writes_one_flight_bundle_as_the_reference(
        models, tmp_path):
    """A stream whose deadline passes while it waits: failed with
    ``deadline_exceeded``, a queued span with the error, one
    ``deadline_miss`` bundle holding its tree, in both packages."""
    prompts = [[3, 7, 1, 9, 4], [5, 2, 8]]
    got = []
    for pkg, m in zip((JAX, TORCH), models):
        flight = pkg[3]
        run = _serve(pkg, m, prompts, timeouts={1: 0.0})
        bundles = flight.summary()["bundles"]
        queued = [e[5] for e in run["events"] if e[1] == "serving.queued"
                  and e[5].get("error")]
        got.append((run["tokens"][1], len(bundles),
                    [os.path.basename(b).split("_")[1] for b in bundles],
                    [q["error"] for q in queued],
                    [ln for ln in run["samples"]
                     if ln.startswith("flight_bundles_total")]))
        flight.reset()
    assert got[1] == got[0]
    assert got[1][:2] == ("deadline_exceeded", 1)


def test_a_second_scheduler_starts_from_its_own_gauges(models):
    """Gauges are process-wide: a vanilla scheduler after a speculative
    one reads its own accept rate (0) and tokens a step (1), and an
    unpaged one after a paged one no pool."""
    prompts = ARMS["spec"][0]
    spec = _serve(TORCH, models[1], prompts, spans=None, spec=True,
                  paged=True)
    vanilla = _serve(TORCH, models[1], prompts, spans=None)
    first = dict(ln.rsplit(" ", 1) for ln in spec["samples"])
    then = dict(ln.rsplit(" ", 1) for ln in vanilla["samples"])
    assert float(first["decode_spec_accept_rate"]) > 0
    assert float(first['kv_blocks_total{decode_kv_dtype="float32"}']) > 0
    assert float(then["decode_spec_accept_rate"]) == 0
    assert float(then["decode_tokens_per_step"]) == 1
    assert float(then['kv_blocks_total{decode_kv_dtype="float32"}']) == 0
    assert float(then["decode_batch_occupancy_pct"]) == 0


def _fit_spans(mx, tel, fused, monkeypatch):
    """Spans and train-bytes gauges of a ``Module.fit`` of two batches of
    4 (and an evaluation of them) in one package."""
    monkeypatch.setenv("MXNET_FUSED_FIT", "1" if fused else "0")
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data, num_hidden=4, name="fc")
    net = mx.sym.SoftmaxOutput(fc, name="softmax")
    rng = np.random.RandomState(0)
    x = rng.randn(8, 5).astype(np.float32)
    y = rng.randint(0, 4, 8).astype(np.float32)
    kw = {} if mx.__name__ == "mxnet_tpu" else {"ctx": "cpu"}
    it = mx.io.NDArrayIter(x, y, batch_size=4, label_name="softmax_label")
    ev = mx.io.NDArrayIter(x, y, batch_size=4, label_name="softmax_label")
    mod = mx.mod.Module(net, context=mx.cpu() if not kw else "cpu")
    tel.enable_spans("all")
    mod.fit(it, eval_data=ev, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    tel.disable_spans()
    spans = collections.Counter((e[2], e[1]) for e in tel.drain_events()
                                if e[2] == "executor")
    gauges = sorted(ln for ln in tel.registry.exposition().splitlines()
                    if ln.startswith("train_"))
    return spans, gauges


@pytest.mark.parametrize("fused", [True, False])
def test_module_fit_records_the_reference_spans_and_gauges(fused,
                                                           monkeypatch):
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx

    want, want_g = _fit_spans(jmx, jtel, fused, monkeypatch)
    got, got_g = _fit_spans(tmx, ttel, fused, monkeypatch)
    assert got_g == want_g
    # the port's training forward is its own graph run: one more
    # executor.forward a training batch than the reference's fused
    # forward-and-backward records
    extra = collections.Counter() if fused else collections.Counter(
        {("executor", "executor.forward"): 2})
    assert got == want + extra
    if fused:
        assert got[("executor", "executor.train_step")] == 2
        assert got_g == ['train_grad_bytes{stage="0"} 96',
                         'train_opt_bytes{stage="0"} 96',
                         'train_param_bytes{stage="0"} 96']
    else:
        assert got[("executor", "model.update_params")] == 2
        assert got[("executor", "executor.backward")] == 2
    assert got[("executor", "executor.forward")] >= 2    # the evaluation


def test_train_step_span_wraps_each_call_and_never_the_body(monkeypatch):
    """``executor.train_step`` is recorded once a call, on the host side
    of the step; the gauges are set once, from the tensors' sizes."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import executor as texe

    sym = tmx.models.get_symbol("mlp", num_classes=3, hidden=(4,))
    exe = sym.simple_bind("cpu", data=(2, 5), softmax_label=(2,))
    names = [n for n in exe._arg_names if exe.grad_req[n] != "null"]

    def update(params, grads, states, *extra):
        return {n: params[n] - 0.1 * grads[n] for n in params}, states

    calls = []
    body = texe._TrainStep._body
    monkeypatch.setattr(texe._TrainStep, "_body", lambda self, extra: (
        calls.append(ttel.enabled("executor")), body(self, extra))[1])
    step = exe.make_train_step(update)
    params = {n: exe.arg_dict[n] for n in names}
    ttel.enable_spans("executor")
    for _ in range(3):
        _, params, _ = step(params, None, {})
    ttel.disable_spans()
    spans = [e for e in ttel.drain_events() if e[1] == "executor.train_step"]
    assert len(spans) == 3 == len(calls)
    assert spans[0][5] == {"chain": 1, "sharded": False, "stage": 0}
    pb = sum(exe.arg_dict[n]._data.numel() * 4 for n in names)
    assert ('train_param_bytes{stage="0"} %d' % pb) in \
        ttel.registry.exposition()
