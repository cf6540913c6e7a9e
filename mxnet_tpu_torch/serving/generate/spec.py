"""Speculative decoding, and the host-side sampling every decode path
shares (f64 numpy).

Counterpart of ``mxnet_tpu/serving/generate/spec.py``, its acceptance
math kept bitwise. Draft k, then verify (Leviathan et al., *Fast Inference
from Transformers via Speculative Decoding*): each scheduler iteration the
DRAFT model (the target quantized to int8 by default) runs ``spec_tokens``
fixed-shape decode steps, then one verify of the TARGET model scores all
k + 1 window positions at once. Rejection sampling accepts 0..k draft
tokens plus a correction or bonus token, so the stream follows the
target's distribution whatever the draft; greedy acceptance is the
longest matching prefix, so greedy spec streams are vanilla streams.

KV: the draft steps write draft k/v at the window positions (clamped to
capacity - 1); the verify masks the cache at each row's length, so the
draft's writes are invisible to it, and writes target k/v over every
window position. After the verify the cache holds target k/v through
every committed position, and a rejection is ``truncate()`` on the cache
manager, a host-side length (paged: table) edit, never a copy. ``keff``
keeps acceptance inside capacity and, paged, inside the admission
reservation, so no stream allocates a block mid-stream.

One engine op an iteration runs the k draft steps, the verify and the
acceptance; the scheduler fences it, then truncates and emits. The op
runs inside the iteration's ``decode.step`` span (``spec=k``), the draft
steps inside ``decode.draft`` and the verify inside ``decode.verify``
(domain ``serving``, the reference's names), each around the host side of
its calls and the reads of their logits. With several replicas each has
its op (on its own program set and cache); one fence covers them. The
reference's engine capture is not ported.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ... import engine as _engine
from ... import telemetry as _telemetry
from ..batcher import ServingError


# --- sampling / acceptance math (host-side, f64) --------------------------
def _softmax64(logits, temperature: float) -> np.ndarray:
    """f64 softmax on the host — the one place sampling probabilities are
    computed, so vanilla and speculative paths share identical math."""
    z = np.asarray(logits, np.float64) / max(float(temperature), 1e-8)
    z = z - z.max()
    e = np.exp(z)
    return e / e.sum()


def _draw(probs: np.ndarray, rng) -> int:
    """One inverse-CDF draw (clamped against fp round-off in the cumsum
    tail)."""
    u = rng.random_sample()
    idx = int(np.searchsorted(np.cumsum(probs), u, side="right"))
    return min(idx, len(probs) - 1)


def sample_token(logits, temperature: float, rng) -> int:
    """Greedy argmax at temperature 0 (or without an rng), else one draw
    from the f64 softmax."""
    if temperature <= 0.0 or rng is None:
        return int(np.asarray(logits).argmax())
    return _draw(_softmax64(logits, temperature), rng)


def accept_greedy(draft: List[int], vlogits,
                  k_eff: int) -> Tuple[int, List[int]]:
    """Longest matching prefix: each draft token against the target's
    argmax. Returns ``(accepted, emitted)``, ``len(emitted) == accepted +
    1``: the last token is the target's correction (first mismatch) or
    bonus (whole window accepted). ``k_eff == 0`` is one vanilla greedy
    step."""
    emitted: List[int] = []
    for j in range(int(k_eff)):
        t = int(np.asarray(vlogits[j]).argmax())
        emitted.append(t)
        if t != int(draft[j]):
            return j, emitted
    emitted.append(int(np.asarray(vlogits[int(k_eff)]).argmax()))
    return int(k_eff), emitted


def accept_sampled(draft: List[int], draft_probs, vlogits, k_eff: int,
                   temperature: float, rng) -> Tuple[int, List[int]]:
    """Leviathan rejection sampling: accept draft ``d_j`` with probability
    ``min(1, p[d] / q[d])``; the first rejection draws from the residual
    ``max(p - q, 0)`` (``p`` where it vanishes numerically); a fully
    accepted window draws a bonus from the target's last position."""
    emitted: List[int] = []
    for j in range(int(k_eff)):
        p = _softmax64(vlogits[j], temperature)
        q = np.asarray(draft_probs[j], np.float64)
        d = int(draft[j])
        if rng.random_sample() < min(1.0, p[d] / max(q[d], 1e-300)):
            emitted.append(d)
            continue
        resid = np.maximum(p - q, 0.0)
        s = resid.sum()
        emitted.append(_draw(resid / s if s > 0.0 else p, rng))
        return j, emitted
    emitted.append(_draw(_softmax64(vlogits[int(k_eff)], temperature), rng))
    return int(k_eff), emitted


def _logits_np(t) -> np.ndarray:
    return t.float().cpu().numpy()


# --- the scheduler's speculative iteration ---------------------------------
class SpecDecoder:
    """The draft-k-then-verify iteration of a ``DecodeScheduler`` with
    ``GenerateConfig.spec``. It holds no state but the scheduler: the
    bookkeeping stays on the scheduler and its cache manager, so stats,
    drain and the failed-step recovery are the vanilla ones."""

    def __init__(self, sched):
        self.sched = sched
        self.k = int(sched.config.spec_tokens)

    def step_all(self):
        """One iteration over the occupied slots of every replica: ONE
        engine op a replica (k draft steps, the verify and the
        acceptance), one fence over them, then the commit: truncate each
        row to its accepted length and emit 1..k+1 tokens."""
        sched = self.sched
        k = self.k
        cap = sched.programs.capacity
        with sched._cond:
            by_rep: Dict[int, list] = {}
            for (rep, _slot), a in sorted(sched._active.items()):
                by_rep.setdefault(rep, []).append(a)
        stepped = []          # (replica, [active...], holder)
        for rep, actives in sorted(by_rep.items()):
            cache = sched.caches[rep]
            n0 = np.zeros(cache.slots, np.int64)
            t0 = np.zeros(cache.slots, np.int64)
            keff = np.zeros(cache.slots, np.int64)
            for a in actives:
                n0[a.slot] = cache.length(a.slot)
                t0[a.slot] = a.last_token
                # emit at most keff + 1 tokens: within max_new_tokens,
                # within capacity and (paged) the admission reservation,
                # so accepted positions never need a block try_admit did
                # not reserve
                remaining = a.stream.max_new_tokens - a.generated
                keff[a.slot] = max(0, min(k, remaining - 1,
                                          cap - 1 - int(n0[a.slot])))
            active = n0 > 0
            tables = cache.step_arrays()[1] if sched.config.paged else None
            # each row's sampling context, used inside the op: the
            # scheduler fences before it touches these streams again
            samplers = {a.slot: (a.temperature, a.rng) for a in actives
                        if a.temperature > 0.0 and a.rng is not None}
            holder: Dict[str, object] = {}
            stepped.append((rep, actives, holder))

            def op(cache=cache, n0=n0, t0=t0, keff=keff, tables=tables,
                   samplers=samplers, active=active, holder=holder):
                try:
                    with _telemetry.span("decode.step", domain="serving",
                                         rows=int(active.sum()), spec=k):
                        holder["res"] = self._speculate(
                            cache, n0, t0, keff, tables, samplers, active)
                except Exception as e:      # noqa: BLE001 — reported below
                    holder["error"] = e

            _engine.push(op, mutable_vars=[cache.var], name="decode.step")
        if not stepped:
            return
        _engine.fence([sched.caches[rep].var for rep, _, _ in stepped]).wait()
        sched.steps += 1
        for rep, actives, holder in stepped:
            sched.replica_steps[rep] += 1
            cache = sched.caches[rep]
            err = holder.get("error")
            if err is not None:
                # a failed in-place iteration may leave the slabs half
                # written: rebuild the replica's cache (the vanilla
                # recovery)
                for a in actives:
                    sched._retire(a, error=ServingError(
                        "decode step failed: %s" % err,
                        code="dispatch_error"))
                cache.reset()
                continue
            res = holder["res"]
            for a in actives:
                base, kk, acc, emitted = res[a.slot]
                # the cache holds target k/v through base + acc (the
                # verify wrote the window): a rejection is this one edit
                cache.truncate(a.slot, base + 1 + acc)
                sched.seq_steps += 1
                sched.step_tokens += len(emitted)
                sched.drafted_tokens += kk
                sched.accepted_tokens += acc
                for m, tok in enumerate(emitted):
                    if not sched._emit(a, tok, length=base + 1 + m):
                        break

    def _speculate(self, cache, n0, t0, keff, tables, samplers, active):
        """The device part (engine worker): k draft steps, the verify, the
        acceptance. Every array is (slots,) or (slots, W) whatever the
        occupancy, so each captured step keeps its shapes."""
        programs = cache.programs       # the replica's program set
        k = self.k
        cap = programs.capacity
        W = k + 1
        scales = {"ks_slab": cache.k_scale, "vs_slab": cache.v_scale}
        wtok = np.zeros((cache.slots, W), np.int64)
        wtok[:, 0] = t0
        qprobs: Dict[Tuple[int, int], np.ndarray] = {}
        cur = t0.copy()
        with _telemetry.span("decode.draft", domain="serving", k=k):
            for j in range(k):
                # a row near capacity parks its tail drafts on the last
                # position (the verify rewrites it; keff keeps anything
                # accepted below capacity)
                lens_j = np.where(active, np.minimum(n0 + j, cap - 1), 0)
                if tables is not None:
                    out = programs.decode(cache.k_slab, cache.v_slab,
                                          tables, lens_j, cur, **scales)
                else:
                    out = programs.decode(cache.k_slab, cache.v_slab,
                                          lens_j, cur, **scales)
                logits = _logits_np(out)
                cur = logits.argmax(axis=-1).astype(np.int64)
                for slot, (temp, rng) in sorted(samplers.items()):
                    # draw only for lanes the row can accept: the others
                    # stay argmax, so the stream's generator does not drift
                    if j < int(keff[slot]):
                        q = _softmax64(logits[slot], temp)
                        qprobs[(slot, j)] = q
                        cur[slot] = _draw(q, rng)
                wtok[:, j + 1] = cur
        vlens = np.where(active, n0, 0)
        with _telemetry.span("decode.verify", domain="serving", window=W):
            if tables is not None:
                out = programs.verify(cache.k_slab, cache.v_slab, tables,
                                      vlens, wtok, **scales)
            else:
                out = programs.verify(cache.k_slab, cache.v_slab, vlens,
                                      wtok, **scales)
            vlogits = _logits_np(out)                 # (slots, W, V)
        res: Dict[int, Tuple[int, int, int, List[int]]] = {}
        for slot in np.nonzero(active)[0]:
            slot = int(slot)
            kk = int(keff[slot])
            draft = [int(wtok[slot, j + 1]) for j in range(kk)]
            ctx = samplers.get(slot)
            if ctx is None:
                acc, emitted = accept_greedy(draft, vlogits[slot], kk)
            else:
                temp, rng = ctx
                acc, emitted = accept_sampled(
                    draft, [qprobs[(slot, j)] for j in range(kk)],
                    vlogits[slot], kk, temp, rng)
            res[slot] = (int(n0[slot]), kk, acc, emitted)
        return res
