"""Speculative decoding of mxnet_tpu_torch against mxnet_tpu.

The small LM of ``test_torch_decode.py`` (L 2, d 64, H 4, Hkv 2, V 64)
and the same numpy weights go into both packages. The acceptance math is
bitwise the reference's on the reference's own cases; the verify
programs (unpaged and paged, f32 and int8 KV, a row within W of capacity)
give logits and slabs within the decode tests' 1e-4 (int8 values equal
but for a round-half unit, scales within 1e-6 relative), and write
nothing for a lane past capacity; rewinds keep the admission reservation
and never free a shared prefix block; the schedulers' speculative streams
(greedy with the int8 and the self draft, paged and unpaged; sampled from
one seed) and their counters equal the reference's, and greedy spec
streams equal the port's own vanilla streams.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.serving import generate as jgen
from mxnet_tpu.serving.generate import spec as jspec
from mxnet_tpu_torch.serving import ServingError
from mxnet_tpu_torch.serving import generate as tgen
from mxnet_tpu_torch.serving.generate import spec as tspec

from test_torch_decode import H, HKV, TOL, _close, _models
from test_torch_paged import SCALE_RTOL, _int8_close, _managers, _state

V = 64


# --- the acceptance math: the reference's own cases -------------------------

def _logits_for(tokens):
    z = np.zeros((len(tokens), V), np.float32)
    for j, t in enumerate(tokens):
        z[j, t] = 5.0
    return z


def _softmax_rows(logits):
    z = np.asarray(logits, np.float64)
    z = z - z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return list(e / e.sum(axis=-1, keepdims=True))


class _FixedRng:
    def __init__(self, values):
        self._values = list(values)

    def random_sample(self):
        return self._values.pop(0)


@pytest.mark.parametrize("draft,targets,k", [
    ([7, 9, 2], [7, 9, 2, 4], 3), ([7, 9, 2], [8, 9, 2, 4], 3),
    ([7, 9, 2], [7, 9, 6, 4], 3), ([], [5], 0), ([7, 9, 2], [7, 9, 2, 4], 1)])
def test_accept_greedy_equals_the_reference(draft, targets, k):
    vlogits = _logits_for(targets)
    got = tspec.accept_greedy(draft, vlogits, k)
    assert got == jspec.accept_greedy(draft, vlogits, k)
    assert len(got[1]) == got[0] + 1


def _sampled_cases():
    p_logits = _logits_for([7, 9, 3])
    yield ([7, 9], _softmax_rows(p_logits[:2]), p_logits, 2,
           [0.99, 0.99, 0.5])
    q0 = np.zeros(V)
    q0[7] = 1.0
    yield [7], [q0], _logits_for([8, 9]), 1, [0.5, 0.5]
    p = np.full(V, 1e-9)
    p[7], p[8] = 0.5, 0.5 - 1e-9 * (V - 2)
    q = np.zeros(V)
    q[7] = 1.0
    pl = np.log(np.stack([p, p]) + 1e-300).astype(np.float64)
    yield [7], [q], pl, 1, [0.4, 0.0, 0.0]
    yield [7], [q], pl, 1, [0.6, 0.5]


@pytest.mark.parametrize("case", range(4))
def test_accept_sampled_equals_the_reference(case):
    draft, qs, vlogits, k, draws = list(_sampled_cases())[case]
    got = tspec.accept_sampled(draft, qs, vlogits, k, 1.0, _FixedRng(draws))
    want = jspec.accept_sampled(draft, qs, vlogits, k, 1.0,
                                _FixedRng(draws))
    assert got == want


def test_accept_sampled_with_seeded_generators_equals_the_reference():
    rng = np.random.RandomState(0)
    vlogits = rng.randn(5, V).astype(np.float32) * 2
    qs = _softmax_rows(rng.randn(4, V) * 2)
    draft = [int(np.argmax(q)) for q in qs]
    for seed in range(20):
        got = tspec.accept_sampled(draft, qs, vlogits, 4, 0.8,
                                   np.random.RandomState(seed))
        want = jspec.accept_sampled(draft, qs, vlogits, 4, 0.8,
                                    np.random.RandomState(seed))
        assert got == want


# --- the verify programs ------------------------------------------------------

CAP, W = 24, 5


def _verify_pair(kv_dtype):
    """Both packages' unpaged programs (3 slots, capacity 24, verify
    window 5) with slot 0 holding a 5-token prompt and slot 1 a 22-token
    one (within W of capacity: three of its lanes fall past it), slot 2
    inactive. Returns (jax programs, port programs, jax slabs, port
    slabs, lengths)."""
    jm, tm = _models()
    jp = jgen.DecodePrograms(jm, 3, CAP, (8, 24), kv_dtype=kv_dtype)
    tp = tgen.DecodePrograms(tm, 3, CAP, (8, 24), kv_dtype=kv_dtype)
    jp.enable_verify(W)
    tp.enable_verify(W)
    j = list(jp.fresh_slabs()) + list(jp.fresh_scale_slabs() or ())
    t = list(tp.fresh_slabs()) + list(tp.fresh_scale_slabs() or ())
    prompts = [[3, 7, 1, 9, 4], [(5 * i + 2) % V for i in range(22)]]
    for slot, p in enumerate(prompts):
        jpre, tpre = jp.prefill(p), tp.prefill(p)
        if kv_dtype == "int8":
            j = list(jp.admit(j[0], j[1], jpre[1], jpre[2], slot,
                              ks_slab=j[2], vs_slab=j[3], ks_new=jpre[3],
                              vs_new=jpre[4]))
            tp.admit(t[0], t[1], tpre[1], tpre[2], slot, ks_slab=t[2],
                     vs_slab=t[3], ks_new=tpre[3], vs_new=tpre[4])
        else:
            j = list(jp.admit(j[0], j[1], jpre[1], jpre[2], slot))
            tp.admit(t[0], t[1], tpre[1], tpre[2], slot)
    return jp, tp, j, t, np.array([5, 22, 0], np.int32)


def _slabs_equal_within(t, j, kv_dtype, trash=False):
    cut = slice(1, None) if trash else slice(None)
    if kv_dtype != "int8":
        for a, b in zip(t, j):
            _close(a[:, cut], np.asarray(b, np.float32)[:, cut])
        return
    for i, (a, b) in enumerate(zip(t[:2], j[:2])):
        assert _int8_close(a[:, cut], np.asarray(b)[:, cut], i) == 0
    for a, b in zip(t[2:], j[2:]):
        np.testing.assert_allclose(a[:, cut].numpy(),
                                   np.asarray(b)[:, cut], rtol=SCALE_RTOL,
                                   atol=0)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_verify_matches_jax_and_drops_lanes_past_capacity(kv_dtype):
    jp, tp, j, t, lengths = _verify_pair(kv_dtype)
    before = [x.clone() for x in t]
    wtok = np.array([[11, 4, 9, 30, 2], [8, 8, 1, 60, 5], [0, 0, 0, 0, 0]],
                    np.int32)
    jout = jp.verify(*j[:2], lengths, wtok, *j[2:])
    tlog = tp.verify(*t[:2], lengths, wtok, *t[2:])
    assert tuple(tlog.shape) == (3, W, V)
    _close(tlog, jout[0])
    _slabs_equal_within(t, list(jout[1:]), kv_dtype)
    # what the verify may write: each row's positions from its length up
    # to capacity; everything below a row's length is as it was, and row
    # 1's lanes past capacity (24, 25, 26) wrote nothing anywhere
    for new_slab, old_slab in zip(t, before):
        for row, n in enumerate(lengths):
            keep = torch.ones(CAP, dtype=torch.bool)
            keep[int(n):int(n) + W] = False
            assert torch.equal(_positions(new_slab, row, keep),
                               _positions(old_slab, row, keep))


def _positions(slab, row, keep):
    """Row ``row``'s cached positions ``keep`` of a value slab (L, B, Hkv,
    C, Dh) or a scale slab (L, B, C)."""
    rows = slab[:, row]
    return rows[:, :, keep] if slab.dim() == 5 else rows[:, keep]


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_verify_window_equals_the_decode_steps_it_replaces(kv_dtype):
    """A window fed the tokens that decode steps were fed gives the decode
    steps' logits (the draft-free accept path), within 1e-4."""
    _, tm = _models()
    progs = tgen.DecodePrograms(tm, 3, CAP, (8, 24), kv_dtype=kv_dtype)
    progs.enable_verify(W)
    from mxnet_tpu_torch.tools import lm

    prompt = [3, 7, 1, 9, 4]
    ref, fed = lm.forced_unpaged(progs, prompt, 9)
    got = lm.forced_verify(progs, prompt, fed, W)
    np.testing.assert_allclose(got, ref[1:], atol=TOL, rtol=TOL)


def _paged_verify_pair(kv_dtype):
    """Both packages' paged programs (3 slots, capacity 24, T 4, 18
    blocks, window 5): a 21-token prompt (its reservation the whole
    capacity, so two lanes fall past it) and a joiner sharing its first
    block; the port's manager's plans drive both."""
    jm, tm = _models()
    jp = jgen.PagedDecodePrograms(jm, 3, CAP, (8, 24), 4, 18,
                                  kv_dtype=kv_dtype)
    tp = tgen.PagedDecodePrograms(tm, 3, CAP, (8, 24), 4, 18,
                                  kv_dtype=kv_dtype)
    jp.enable_verify(W)
    tp.enable_verify(W)
    j = list(jp.fresh_slabs()) + list(jp.fresh_scale_slabs() or ())
    t = list(tp.fresh_slabs()) + list(tp.fresh_scale_slabs() or ())
    mgr = tgen.PagedKVCacheManager(tp)
    pa = [(3 * i + 1) % V for i in range(21)]
    pb = pa[:6] + [9, 9]
    for who, p in (("a", pa), ("b", pb)):
        plan = mgr.try_admit(who, p, 6)
        args = (plan.table, plan.ctx_len, plan.suffix, plan.fork_src,
                plan.fork_dst)
        jout = jp.paged_prefill(j[0], j[1], *args, *j[2:])
        j = list(jout[1:])
        tp.paged_prefill(t[0], t[1], *args, *t[2:])
    lengths, tables = mgr.step_arrays()
    return jp, tp, j, t, lengths, tables


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_paged_verify_matches_jax(kv_dtype):
    jp, tp, j, t, lengths, tables = _paged_verify_pair(kv_dtype)
    assert lengths[:2].tolist() == [21, 8]
    wtok = np.array([[11, 4, 9, 30, 2], [8, 8, 1, 60, 5], [0, 0, 0, 0, 0]],
                    np.int32)
    jout = jp.verify(j[0], j[1], tables.copy(), lengths.copy(), wtok,
                     *j[2:])
    tlog = tp.verify(t[0], t[1], tables, lengths, wtok, *t[2:])
    _close(tlog[:2], np.asarray(jout[0])[:2])
    # the trash block takes colliding writes (padded lanes, positions past
    # capacity): every other block is compared
    _slabs_equal_within(t, list(jout[1:]), kv_dtype, trash=True)


def test_verify_needs_enable_and_a_window_within_capacity():
    _, tm = _models()
    progs = tgen.DecodePrograms(tm, 2, 8, (8,))
    slabs = progs.fresh_slabs()
    with pytest.raises(ServingError, match="enable_verify"):
        progs.verify(*slabs, np.zeros(2, np.int32), np.zeros((2, 3),
                                                              np.int32))
    with pytest.raises(ServingError, match="exceeds kv capacity"):
        progs.enable_verify(9)
    progs.enable_verify(3)
    st = progs.capture_stats()
    assert st["verify"]["path"] == "eager" and st["path"] == "eager"


# --- rewinds ------------------------------------------------------------------

def test_paged_truncate_keeps_the_reservation_as_the_reference():
    jm, tm = _managers(slots=2)
    free0 = tm.blocks_free()
    plans = [m.try_admit("a", [3, 7, 1, 9, 4], 6) for m in (jm, tm)]
    held = free0 - tm.blocks_free()
    for new_len in (5, 7, 5):                  # reject, accept 2, reject
        for m, p in zip((jm, tm), plans):
            m.truncate(p.slot, new_len)
        assert tm.length(plans[1].slot) == new_len
        assert tm.blocks_free() == free0 - held
        assert _state(tm) == _state(jm)
    for m, p in zip((jm, tm), plans):
        m.free(p.slot)
    assert tm.blocks_free() == free0 and _state(tm) == _state(jm)


def test_paged_truncate_never_frees_a_shared_prefix_block():
    jm, tm = _managers(slots=3)
    free0 = tm.blocks_free()
    for m in (jm, tm):
        a = m.try_admit("a", [3, 7, 1, 9, 4, 2], 6)
        b = m.try_admit("b", [3, 7, 1, 9, 4, 2, 5, 8], 6)
        assert b.forked and int(b.table[0]) == int(a.table[0])
        m.truncate(b.slot, 0, release=True)
    shared = int(a.table[0])
    assert tm.blocks_free() == free0 - 3
    assert int(tm._tables[a.slot][0]) == shared and tm._ref[shared] == 1
    assert _state(tm) == _state(jm)


def test_unpaged_truncate_is_a_length_rollback():
    _, tm = _models()
    cache = tgen.KVCacheManager(tgen.DecodePrograms(tm, 2, 16, (8,)))
    plan = cache.try_admit("a", [5, 4, 3], 6)
    cache.truncate(plan.slot, 5)
    assert cache.length(plan.slot) == 5
    cache.truncate(plan.slot, 3)
    assert cache.length(plan.slot) == 3
    assert cache.active_slots() == [plan.slot]


# --- the scheduler --------------------------------------------------------------

PROMPTS = [[3, 7, 1, 9, 4], [5, 2, 8], [9, 4, 1, 2, 11, 6]]
COUNTERS = ("seq_steps", "step_tokens", "drafted_tokens", "accepted_tokens",
            "spec", "steps")


def _cfg(mod, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("max_context", 24)
    kw.setdefault("prefill_buckets", (4, 8))
    kw.setdefault("max_new_tokens", 6)
    kw.setdefault("block_tokens", 4)
    kw.setdefault("num_blocks", 0)
    kw.setdefault("prefix_share", True)
    for knob, off in (("paged", False), ("spec", False), ("capture", False),
                      ("quant_weights", ""), ("kv_dtype", "f32"),
                      ("eos_id", None), ("spec_tokens", 4),
                      ("spec_draft", "int8")):
        kw.setdefault(knob, off)
    return mod.GenerateConfig(num_heads=H, num_kv_heads=HKV, **kw)


def _run(mod, model, prompts, temperature=0.0, **kw):
    sched = mod.DecodeScheduler(model, _cfg(mod, **kw))
    sched.start()
    try:
        streams = [sched.submit(p, temperature=temperature, seed=i)
                   for i, p in enumerate(prompts)]
        out = [s.tokens(timeout=120) for s in streams]
        reasons = [s.finish_reason for s in streams]
        stats = sched.stats()
    finally:
        sched.stop()
    return out, reasons, stats


@pytest.mark.parametrize("draft", ["int8", "self"])
@pytest.mark.parametrize("paged", [False, True])
def test_greedy_spec_streams_match_jax_and_vanilla(paged, draft):
    jm, tm = _models()
    kw = dict(paged=paged, spec=True, spec_draft=draft)
    jtoks, _, jst = _run(jgen, jm, PROMPTS, **kw)
    ttoks, reasons, tst = _run(tgen, tm, PROMPTS, **kw)
    assert reasons == ["max_tokens"] * 3
    assert ttoks == jtoks
    assert {k: tst[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    vanilla, _, vst = _run(tgen, tm, PROMPTS, paged=paged)
    assert ttoks == vanilla
    assert tst["step_tokens"] > tst["seq_steps"]
    assert tst["decode_spec_accept_rate"] == \
        tst["accepted_tokens"] / tst["drafted_tokens"]
    assert vst["drafted_tokens"] == 0 and vst["spec"] == "off"
    assert vst["step_tokens"] == vst["seq_steps"]
    if paged:
        assert tst["blocks_free"] == tst["blocks_total"]


def test_greedy_spec_with_int8_kv_and_mid_stream_admits_matches_jax():
    """More prompts than slots (late arrivals join rows mid-speculation),
    int8 KV, paged; and every stream is the port's vanilla one."""
    jm, tm = _models()
    prompts = PROMPTS + [[4, 4], [8, 1, 3, 3, 7, 2, 6], [3, 7, 1, 9, 4]]
    kw = dict(paged=True, kv_dtype="int8", spec=True, spec_tokens=3)
    jtoks, _, _ = _run(jgen, jm, prompts, **kw)
    ttoks, reasons, _ = _run(tgen, tm, prompts, **kw)
    assert ttoks == jtoks and reasons == ["max_tokens"] * len(prompts)
    vanilla, _, _ = _run(tgen, tm, prompts, paged=True, kv_dtype="int8")
    assert ttoks == vanilla


def test_sampled_spec_streams_match_jax_for_one_seed():
    jm, tm = _models()
    kw = dict(paged=True, spec=True, spec_tokens=3)
    jtoks, _, _ = _run(jgen, jm, PROMPTS, temperature=0.8, **kw)
    ttoks, _, st = _run(tgen, tm, PROMPTS, temperature=0.8, **kw)
    assert ttoks == jtoks
    assert _run(tgen, tm, PROMPTS, temperature=0.8, **kw)[0] == ttoks
    assert len({tuple(t) for t in ttoks}) > 1
    assert st["drafted_tokens"] > 0


def test_spec_token_budget_of_one_is_the_vanilla_step():
    """max_new_tokens 1: keff is 0 throughout, the verify is the vanilla
    step, nothing is accepted."""
    _, tm = _models()
    got, _, st = _run(tgen, tm, PROMPTS, paged=True, spec=True,
                      max_new_tokens=1)
    assert got == _run(tgen, tm, PROMPTS, paged=True, max_new_tokens=1)[0]
    assert st["accepted_tokens"] == st["drafted_tokens"] == 0


def test_spec_capture_on_the_cpu_runs_eagerly():
    _, tm = _models()
    want, _, _ = _run(tgen, tm, PROMPTS, spec=True)
    got, _, st = _run(tgen, tm, PROMPTS, spec=True, capture=True)
    assert got == want
    assert st["decode_path"] == st["verify_path"] == "eager"
    assert st["verify_captures"] == st["verify_replays"] == 0


def test_spec_drafts_are_the_int8_target_or_the_target():
    _, tm = _models()
    sched = tgen.DecodeScheduler(tm, _cfg(tgen, spec=True))
    assert sched.programs.model is tm
    assert sched.programs.step_model.params["wq"].dtype == torch.int8
    assert sched.programs.spec_window == 5
    sched = tgen.DecodeScheduler(tm, _cfg(tgen, spec=True,
                                          spec_draft="self"))
    assert sched.programs.step_model is tm
    q = tgen.DecodeScheduler(tm, _cfg(tgen, quant_weights="int8",
                                      spec=True))
    assert q.programs.step_model is q.programs.model     # already int8


@pytest.mark.parametrize("knobs,match", [
    (dict(spec=True, spec_tokens=0), "spec_tokens"),
    (dict(spec=True, spec_draft="fp4"), "spec_draft"),
    (dict(quant_weights="int4"), "MXNET_QUANT_WEIGHT_DTYPE")])
def test_config_validation(knobs, match):
    _, tm = _models()
    with pytest.raises(Exception, match=match) as ei:
        tgen.DecodeScheduler(tm, _cfg(tgen, **knobs))
    from mxnet_tpu_torch.base import MXNetError
    assert isinstance(ei.value, MXNetError)


def test_spec_knobs_read_the_env(monkeypatch):
    monkeypatch.setenv("MXNET_DECODE_SPEC", "1")
    monkeypatch.setenv("MXNET_DECODE_SPEC_TOKENS", "3")
    monkeypatch.setenv("MXNET_DECODE_SPEC_DRAFT", "self")
    c = tgen.GenerateConfig(num_heads=H)
    assert (c.spec, c.spec_tokens, c.spec_draft) == (True, 3, "self")
    for name in ("MXNET_DECODE_SPEC_TOKENS", "MXNET_DECODE_SPEC_DRAFT"):
        monkeypatch.delenv(name)
    c = tgen.GenerateConfig(num_heads=H)
    assert (c.spec_tokens, c.spec_draft) == (4, "int8")
