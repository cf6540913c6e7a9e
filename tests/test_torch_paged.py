"""Paged KV, int8 KV and decode capture of mxnet_tpu_torch against
mxnet_tpu.

The small LM of ``test_torch_decode.py`` (L 2, d 64, H 4, Hkv 2, V 64)
and the same numpy weights go into both packages. The paged cache
manager's bookkeeping (tables, refcounts, free lists, plans, prefix
registry, counters) must equal the reference's exactly; the paged prefill
(with and without a copy-on-write fork) and the paged decode must give
logits and slabs within 1e-4 (f32, sums in another order); int8 KV must
give scales within 1e-6 relative, quantized values equal but for the
round-half cases stated below, and logits within 1e-4; the schedulers'
greedy streams and prefix / fork counts must be equal. The reference's
programs run as its own tests run them on the CPU (XLA, no Pallas kernel
on these paths).
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.serving import generate as jgen
from mxnet_tpu.serving.generate import model as jmodel
from mxnet_tpu_torch.serving import ServingError
from mxnet_tpu_torch.serving import generate as tgen
from mxnet_tpu_torch.serving.generate import model as tmodel

from test_torch_decode import H, HKV, TOL, _close, _models

# int8 scales: relative tolerance. Quantized values: equal, except that a
# value whose x / scale lies within f32 rounding of a half may round to
# either neighbour when the two packages' k / v differ in the last bits
SCALE_RTOL = 1e-6


def _paged_progs(tm, slots=3, capacity=24, block_tokens=4, num_blocks=0,
                 buckets=(4, 8), **kw):
    blocks = num_blocks or slots * (-(-capacity // block_tokens))
    return tgen.PagedDecodePrograms(tm, slots, capacity, buckets,
                                    block_tokens, blocks, **kw)


def _managers(slots=3, capacity=24, block_tokens=4, num_blocks=0,
              prefix_share=True):
    """(reference manager, port manager) over the same pool. The
    reference's manager is host-only bookkeeping; it gets a stand-in for
    its programs (the shapes it reads), so no XLA program is compiled."""
    _, tm = _models()
    progs = _paged_progs(tm, slots, capacity, block_tokens, num_blocks,
                         buckets=(min(8, capacity),))
    stand_in = types.SimpleNamespace(
        slots=progs.slots, capacity=progs.capacity,
        block_tokens=progs.block_tokens, max_blocks=progs.max_blocks,
        num_blocks=progs.num_blocks, fresh_slabs=lambda: (None, None),
        fresh_scale_slabs=lambda: None)
    return (jgen.PagedKVCacheManager(stand_in, prefix_share=prefix_share),
            tgen.PagedKVCacheManager(progs, prefix_share=prefix_share))


def _state(m):
    lengths, tables = m.step_arrays()
    return {"lengths": lengths.tolist(), "tables": tables.tolist(),
            "owner": list(m._owner), "free_slots": list(m._free_slots),
            "free_blocks": list(m._free_blocks), "ref": m._ref.tolist(),
            "reserved": m._reserved.tolist(),
            "full": dict(m._full_index),
            "partial": {k: (b, tuple(t))
                        for k, (b, t) in m._partial_index.items()},
            "block_keys": {b: list(v) for b, v in m._block_keys.items()},
            "counters": (m.prefix_hits, m.prefix_tokens_saved, m.cow_forks),
            "blocks": (m.blocks_free(), m.blocks_total()),
            "occupancy": m.occupancy_pct(), "active": m.active_slots()}


def _plan(p):
    if p is None:
        return None
    return (p.slot, list(p.suffix), p.ctx_len, p.table.tolist(), p.fork_src,
            p.fork_dst, p.forked)


# the sequences of tests/test_paged_decode.py's manager tests, then
# truncation and a longer mix: (pool kwargs, ops)
SEQUENCES = {
    "reservation_and_free": (dict(slots=2), [
        ("admit", "a", [3, 7, 1, 9, 4], 6), ("free", "a"),
        ("admit", "b", [3, 7, 1, 9, 4], 6)]),
    "prefix_share_and_refcounts": (dict(), [
        ("admit", "a", [3, 7, 1, 9, 4, 2], 6),
        ("admit", "b", [3, 7, 1, 9, 4, 2, 5, 8], 6),
        ("free", "a"), ("free", "b")]),
    "never_shares_whole_prompt": (dict(), [
        ("admit", "a", [3, 7, 1, 9, 4, 2], 6),
        ("admit", "b", [3, 7, 1, 9, 4, 2], 6),
        ("admit", "c", [3, 7, 1, 9], 6)]),
    "exhaustion": (dict(slots=4, capacity=16, num_blocks=4,
                        prefix_share=False), [
        ("admit", "a", [1, 2, 3, 4, 5], 8), ("admit", "b", [6, 7, 8], 8),
        ("free", "a"), ("admit", "b", [6, 7, 8], 8)]),
    "truncate": (dict(), [
        ("admit", "a", [3, 7, 1, 9, 4, 2], 10),
        ("admit", "b", [3, 7, 1, 9, 4, 2, 5, 8, 6], 10),
        ("advance", "a"), ("advance", "a"), ("advance", "b"),
        ("truncate", "a", 5, False), ("truncate", "b", 3, False),
        ("truncate", "b", 3, True), ("truncate", "b", 3, True),
        ("truncate", "a", 9, True), ("free", "b"), ("free", "a"),
        ("truncate", "a", 2, True)]),
    "mix": (dict(slots=4, capacity=32, num_blocks=20), [
        ("admit", "a", [1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 4),
        ("admit", "b", [1, 2, 3], 4),
        ("admit", "c", [1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 12], 4),
        ("admit", "d", [9, 9, 9, 9, 9], 20), ("free", "a"),
        ("admit", "e", [1, 2, 3, 4, 5, 6, 7, 8, 1], 4), ("free", "c"),
        ("admit", "f", [1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 13], 4),
        ("free", "b"), ("free", "d"), ("free", "e"), ("free", "f"),
        ("admit", "g", [1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 4)]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_manager_bookkeeping_equals_the_reference(name):
    kw, ops = SEQUENCES[name]
    jm, tm = _managers(**kw)
    slots = {}
    peak = 0
    assert _state(tm) == _state(jm)
    for op in ops:
        if op[0] == "admit":
            _, who, prompt, max_new = op
            jp = jm.try_admit(who, prompt, max_new)
            tp = tm.try_admit(who, prompt, max_new)
            assert _plan(tp) == _plan(jp), op
            if tp is not None:
                slots[who] = tp.slot
        elif op[0] == "free":
            jm.free(slots[op[1]])
            tm.free(slots[op[1]])
        elif op[0] == "advance":
            assert tm.advance(slots[op[1]]) == jm.advance(slots[op[1]])
        else:
            _, who, new_len, release = op
            jm.truncate(slots[who], new_len, release=release)
            tm.truncate(slots[who], new_len, release=release)
        assert _state(tm) == _state(jm), op
        peak = max(peak, tm.blocks_total() - tm.blocks_free())
    # the most blocks in use at once, which the reference does not keep
    assert tm.blocks_peak == peak


def test_manager_refuses_a_prompt_at_capacity_as_the_reference():
    jm, tm = _managers(slots=2, capacity=8)
    prompt = list(range(1, 9))
    with pytest.raises(Exception) as je:
        jm.try_admit("a", prompt, 4)
    with pytest.raises(ServingError) as te:
        tm.try_admit("a", prompt, 4)
    assert te.value.code == je.value.code == "too_large"


def test_chain_hash_is_the_reference_hash():
    from mxnet_tpu.serving.generate import paged as jpaged
    from mxnet_tpu_torch.serving.generate import paged as tpaged

    for prev, toks in (("root", [1, 2, 3]), ("ab" * 20, []), ("x", [0])):
        assert tpaged._chain_hash(prev, toks) == jpaged._chain_hash(prev,
                                                                    toks)
    assert tpaged.TRASH_BLOCK == jpaged.TRASH_BLOCK == 0


# --- programs: paged prefill / decode and int8 against the reference -------

def _slabs_close(tk, jk, tol=TOL):
    """Slabs without the trash block, whose padded writes collide."""
    _close(tk[:, 1:], np.asarray(jk, np.float32)[:, 1:], tol)


def _int8_close(got, want, what):
    """int8 tensors: equal but for one unit where a value lies within
    rounding of a half; returns the count of such values."""
    got = got.numpy().astype(np.int32)
    want = np.asarray(want).astype(np.int32)
    diff = np.abs(got - want)
    assert diff.max(initial=0) <= 1, what
    return int((diff > 0).sum())


def _scales_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCALE_RTOL,
                               atol=0)


def _paged_pair(kv_dtype):
    """Both packages' paged programs (slots 3, capacity 24, T 4, 18
    blocks) and fresh slabs (+ scales for int8)."""
    jm, tm = _models()
    jprogs = jgen.PagedDecodePrograms(jm, 3, 24, (4, 8), 4, 18,
                                      kv_dtype=kv_dtype)
    tprogs = _paged_progs(tm, kv_dtype=kv_dtype)
    j = list(jprogs.fresh_slabs()) + list(jprogs.fresh_scale_slabs() or ())
    t = list(tprogs.fresh_slabs()) + list(tprogs.fresh_scale_slabs() or ())
    return jprogs, tprogs, j, t


def _compare_slabs(t, j, kv_dtype):
    """Returns the count of int8 values one unit apart."""
    if kv_dtype != "int8":
        for a, b in zip(t, j):
            _slabs_close(a, b)
        return 0
    off = sum(_int8_close(a[:, 1:], np.asarray(b)[:, 1:], i)
              for i, (a, b) in enumerate(zip(t[:2], j[:2])))
    for a, b in zip(t[2:], j[2:]):
        _scales_close(a[:, 1:], np.asarray(b)[:, 1:])
    return off


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_paged_prefill_fork_and_decode_match_jax(kv_dtype):
    """A cold prompt, then a joiner that shares its first block and forks
    the boundary block (the plans from the manager), then three
    teacher-forced steps over 3 slots (slot 2 inactive)."""
    jprogs, tprogs, j, t = _paged_pair(kv_dtype)
    mgr = tgen.PagedKVCacheManager(tprogs)
    pa, pb = [3, 7, 1, 9, 4, 2], [3, 7, 1, 9, 4, 2, 5, 8]
    plans = [mgr.try_admit("a", pa, 6), mgr.try_admit("b", pb, 6)]
    assert not plans[0].forked and plans[1].forked
    assert plans[1].ctx_len == 6 and plans[1].suffix == [5, 8]
    off = 0
    for plan in plans:
        args = (plan.table, plan.ctx_len, plan.suffix, plan.fork_src,
                plan.fork_dst)
        jout = jprogs.paged_prefill(j[0], j[1], *args,
                                    *([j[2], j[3]] if len(j) == 4 else []))
        j = list(jout[1:])
        tl = tprogs.paged_prefill(t[0], t[1], *args,
                                  *([t[2], t[3]] if len(t) == 4 else []))
        _close(tl, jout[0])
        off += _compare_slabs(t, j, kv_dtype)
    lengths, tables = mgr.step_arrays()
    for step, tokens in enumerate(([5, 11, 0], [6, 12, 0], [7, 13, 0])):
        tokens = np.array(tokens, np.int32)
        jout = jprogs.decode(j[0], j[1], tables.copy(), lengths.copy(),
                             tokens, *j[2:])
        j = list(jout[1:])
        tlog = tprogs.decode(t[0], t[1], tables, lengths, tokens, *t[2:])
        _close(tlog[:2], np.asarray(jout[0])[:2])
        off += _compare_slabs(t, j, kv_dtype)
        lengths[:2] += 1
    # none of this data lands within rounding of a half
    assert off == 0


def test_quantize_kv_matches_the_reference_at_round_half():
    """Random k/v plus values placed exactly on halves of their scale: the
    two packages quantize each to the same int8 (both round half to
    even, from one f32 division) and the same scale."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, HKV, 7, 16).astype(np.float32)
    # position 0 of each row: amax 127 * s, the rest k + 0.5 of s
    s = np.float32(0.25)
    x[..., 0, :] = (np.arange(16) % 9 - 4 + 0.5) * s
    x[..., 0, 0] = 127 * s
    jq, js = jmodel._quantize_kv(jnp.asarray(x))
    tq, ts = tmodel._quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _scales_close(ts, js)
    assert _int8_close(tq, jq, "quantized") == 0
    # round half to even on the placed halves: -2.5 -> -2, -3.5 -> -4
    assert tq[0, 0, 0, 0, 1].item() == -2 and tq[0, 0, 0, 0, 0].item() == 127
    assert tq[0, 0, 0, 0, 9].item() == -4


def test_int8_prefill_decode_and_admit_match_jax():
    """The unpaged int8 arm: prefill (quantized after the flash forward),
    admit into slot 1 and three teacher-forced steps."""
    jm, tm = _models()
    slots, cap, bucket = 3, 24, 8
    prompt = [4, 8, 15, 16, 23]
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :len(prompt)] = prompt
    n = np.array([len(prompt)], np.int32)
    jl, *jnew = jax.jit(jm.build_prefill(bucket, cap, "int8"))(
        jm.params, jnp.asarray(toks), jnp.asarray(n))
    tl, *tnew = tm.build_prefill(bucket, cap, "int8")(
        tm.params, torch.from_numpy(toks).long(), torch.from_numpy(n))
    _close(tl, jl)
    off = sum(_int8_close(a, b, "prefill") for a, b in zip(tnew[:2],
                                                           jnew[:2]))
    for a, b in zip(tnew[2:], jnew[2:]):
        _scales_close(a, b)
    shape = tm.kv_slab_shape(slots, cap)
    sshape = tm.kv_scale_slab_shape(slots, cap)
    assert sshape == jm.kv_scale_slab_shape(slots, cap)
    j = list(jm.build_admit(slots, cap, "int8")(
        jnp.zeros(shape, jnp.int8), jnp.zeros(shape, jnp.int8),
        jnp.zeros(sshape), jnp.zeros(sshape), *jnew,
        jnp.asarray(1, jnp.int32)))
    t = [torch.zeros(shape, dtype=torch.int8),
         torch.zeros(shape, dtype=torch.int8), torch.zeros(sshape),
         torch.zeros(sshape)]
    tm.build_admit(slots, cap, "int8")(*t, *tnew, 1)
    jdec = jax.jit(jm.build_decode(slots, cap, "int8"))
    tdec = tm.build_decode(slots, cap, "int8")
    lengths = np.array([0, len(prompt), 0], np.int32)
    for tok in (42, 7, 63):
        tokens = np.array([0, tok, 0], np.int32)
        jlog, *j = jdec(jm.params, *j, jnp.asarray(lengths),
                        jnp.asarray(tokens))
        tlog = tdec(tm.params, *t, torch.from_numpy(lengths),
                    torch.from_numpy(tokens))
        _close(tlog, jlog)
        off += sum(_int8_close(a, b, "decode") for a, b in zip(t[:2], j[:2]))
        for a, b in zip(t[2:], j[2:]):
            _scales_close(a, b)
        lengths[1] += 1
    assert off == 0


@pytest.mark.parametrize("paged", [False, True])
def test_kv_bytes_count_int8_values_and_f32_scales(paged):
    jm, tm = _models()
    if paged:
        jp = jgen.PagedDecodePrograms(jm, 3, 24, (8,), 4, 18,
                                      kv_dtype="int8")
        tp = _paged_progs(tm, kv_dtype="int8", buckets=(8,))
        values = tm.paged_slab_shape(19, 4)
        scales = tm.paged_scale_slab_shape(19, 4)
    else:
        jp = jgen.DecodePrograms(jm, 3, 24, (8,), kv_dtype="int8")
        tp = tgen.DecodePrograms(tm, 3, 24, (8,), kv_dtype="int8")
        values = tm.kv_slab_shape(3, 24)
        scales = tm.kv_scale_slab_shape(3, 24)
    want = 2 * int(np.prod(values)) + 2 * 4 * int(np.prod(scales))
    assert tp.kv_bytes() == jp.kv_bytes() == want
    held = list(tp.fresh_slabs()) + list(tp.fresh_scale_slabs())
    assert sum(x.nbytes for x in held) == want
    assert [x.dtype for x in held] == [torch.int8] * 2 + [torch.float32] * 2


# --- the scheduler: streams and counts equal the reference's ----------------

# test_quant.py's pair sharing a 4-token block prefix, and
# test_paged_decode.py's fork pair and mid-stream admits (2 slots)
PROMPT_SETS = {
    "quant": ([[3, 7, 1, 9, 4, 2, 8, 5], [3, 7, 1, 9, 4, 2, 8, 6],
               [5, 2, 8]], {}),
    "fork": ([[3, 7, 1, 9, 4, 2], [3, 7, 1, 9, 4, 2, 5, 8]], {}),
    "mid_stream": ([[3, 7, 1, 9, 4, 2], [3, 7, 1, 9, 4, 2, 5, 8],
                    [11, 5, 2], [3, 7, 1, 9, 4, 2], [6, 6, 1, 2]],
                   {"slots": 2}),
}
# (paged, kv_dtype) arms
ARMS = [(True, "f32"), (True, "bf16"), (True, "int8"), (False, "int8")]
# counts that follow from the prompts: with every prompt co-resident at
# admission (quant, fork); the mid-stream set's depend on which streams
# are still resident when a slot frees, so only its streams are compared
STAT_KEYS = ("kv_dtype", "kv_bytes", "prefix_hits", "prefix_tokens_saved",
             "cow_forks", "blocks_free", "blocks_total")


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
                      ("eos_id", None)):
        kw.setdefault(knob, off)
    return mod.GenerateConfig(num_heads=H, num_kv_heads=HKV, **kw)


def _serve(mod, model, prompts, **kw):
    sched = mod.DecodeScheduler(model, _cfg(mod, **kw))
    sched.start()
    try:
        streams = [sched.submit(p) for p in prompts]
        out = [s.tokens(timeout=120) for s in streams]
        reasons = [s.finish_reason for s in streams]
        stats = sched.stats()
    finally:
        sched.stop()
    stats.setdefault("kv_bytes", sched.programs.kv_bytes())
    return out, reasons, stats


@pytest.mark.parametrize("name", sorted(PROMPT_SETS))
@pytest.mark.parametrize("paged,kv_dtype", ARMS)
def test_scheduler_streams_match_jax(paged, kv_dtype, name):
    jm, tm = _models()
    prompts, kw = PROMPT_SETS[name]
    kw = dict(kw, paged=paged, kv_dtype=kv_dtype)
    jtoks, _, jst = _serve(jgen, jm, prompts, **kw)
    ttoks, reasons, tst = _serve(tgen, tm, prompts, **kw)
    assert reasons == ["max_tokens"] * len(prompts)
    assert ttoks == jtoks
    keys = [k for k in STAT_KEYS if paged or k in ("kv_dtype", "kv_bytes")]
    if name == "mid_stream":
        keys = [k for k in keys if not k.startswith(("prefix", "cow"))]
    assert {k: tst[k] for k in keys} == {k: jst[k] for k in keys}
    if paged:
        assert tst["blocks_free"] == tst["blocks_total"]
        if name != "mid_stream":
            assert tst["prefix_hits"] == tst["cow_forks"] == 1


@pytest.mark.parametrize("paged,kv_dtype", [(False, "f32"), (True, "int8")])
def test_capture_on_the_cpu_runs_eagerly_with_the_same_streams(paged,
                                                               kv_dtype):
    _, tm = _models()
    prompts = PROMPT_SETS["quant"][0]
    want, _, _ = _serve(tgen, tm, prompts, paged=paged, kv_dtype=kv_dtype)
    got, reasons, st = _serve(tgen, tm, prompts, paged=paged,
                              kv_dtype=kv_dtype, capture=True)
    assert got == want and reasons == ["max_tokens"] * 3
    assert st["decode_path"] == "eager"
    assert st["captures"] == st["replays"] == st["warmup_calls"] == 0
    assert st["steps"] > 0


@pytest.mark.parametrize("paged", [False, True])
def test_decode_has_read_its_host_arrays_when_it_returns(paged):
    """The caller may edit lengths / tokens / tables once decode returns:
    the step's result and the slabs it wrote do not change (the
    reference's step reads views of them asynchronously)."""
    _, tm = _models()
    if paged:
        progs = _paged_progs(tm, capture=True)
        mgr = tgen.PagedKVCacheManager(progs)
        for who, p in (("a", [3, 7, 1, 9, 4, 2]), ("b", [5, 2, 8])):
            plan = mgr.try_admit(who, p, 6)
            progs.paged_prefill(mgr.k_slab, mgr.v_slab, plan.table,
                                plan.ctx_len, plan.suffix, plan.fork_src,
                                plan.fork_dst)
        lengths, tables = mgr.step_arrays()
        slabs = (mgr.k_slab, mgr.v_slab)
        host = [tables, lengths, np.array([5, 11, 0], np.int32)]
    else:
        progs = tgen.DecodePrograms(tm, 3, 24, (8,), capture=True)
        slabs = progs.fresh_slabs()
        for slot, p in ((0, [3, 7, 1, 9, 4, 2]), (1, [5, 2, 8])):
            _, k_new, v_new = progs.prefill(p)
            progs.admit(*slabs, k_new, v_new, slot)
        host = [np.array([6, 3, 0], np.int64), np.array([5, 11, 0],
                                                         np.int64)]
    results = []
    for edit in (False, True):
        k, v = (s.clone() for s in slabs)
        arrays = [a.copy() for a in host]
        logits = progs.decode(k, v, *arrays)
        if edit:
            for a in arrays:
                a[...] = 1
        results.append((logits.clone(), k, v))
    for want, got in zip(results[0], results[1]):
        assert torch.equal(want, got)


@pytest.mark.parametrize("paged", [False, True])
def test_reset_gives_fresh_slabs_and_drops_the_capture(paged, monkeypatch):
    _, tm = _models()
    if paged:
        progs = _paged_progs(tm, kv_dtype="int8", capture=True)
        cache = tgen.PagedKVCacheManager(progs)
        cache.try_admit("a", [1, 2, 3], 4)
    else:
        progs = tgen.DecodePrograms(tm, 3, 24, (8,), kv_dtype="int8",
                                    capture=True)
        cache = tgen.KVCacheManager(progs)
        cache.try_admit("a", [1, 2, 3], 4)
    dropped = []
    monkeypatch.setattr(progs, "drop_capture", lambda: dropped.append(1))
    old = (cache.k_slab, cache.v_slab, cache.k_scale, cache.v_scale)
    cache.k_slab.fill_(1)
    cache.reset()
    assert dropped == [1]
    new = (cache.k_slab, cache.v_slab, cache.k_scale, cache.v_scale)
    assert all(a is not b for a, b in zip(old, new))
    assert not cache.k_slab.any() and cache.k_scale.dtype == torch.float32
    assert cache.active_slots() == [] and cache.occupancy_pct() == 0.0


def test_paged_programs_refuse_the_unpaged_entry_points():
    _, tm = _models()
    progs = _paged_progs(tm, buckets=(8,))
    with pytest.raises(ServingError, match="paged_prefill"):
        progs.prefill([1, 2, 3])
    with pytest.raises(ServingError, match="admit"):
        progs.admit(None, None, None, None, 0)
    with pytest.raises(ServingError, match="scale slabs"):
        _paged_progs(tm, kv_dtype="int8").decode(
            *progs.fresh_slabs(), np.zeros((3, 6), np.int32),
            np.zeros(3, np.int32), np.zeros(3, np.int32))
