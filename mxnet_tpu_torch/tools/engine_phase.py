"""The engine phase's workloads: the LM behind ``InferenceServer`` with the
dispatch captured or fused, and the program cache's warm restart.

``ENGINE`` sizes them at the LM's full width (``tools/lm.py``'s ``LM``):

- the server: the LM with its ``SoftmaxOutput`` head reshaped batch-major
  (:func:`lm_serve_symbol`: (B, T, vocab) probabilities) at T =
  ``serve_seq``, buckets ``buckets``, one replica, ``requests`` requests
  of ``rows`` rows in turn, each sent after the previous one returned (so
  every arm forms the same batches); after ``swap_after`` requests the
  ladder is swapped to ``swap_ladder`` through the server's retune op;
- the warm restart (:func:`restart_main`, one process a role): the LM at T
  = ``restart_seq`` behind an adaptive server over ``restart_buckets``;
  the first process serves ``restart_sizes`` (whose histogram makes the
  tuner add the missing rung), retunes, serves them again and writes the
  outputs' digests; the second, on the same ``MXNET_PROGCACHE_DIR``,
  adopts the saved ladder, serves the same requests and writes its
  digests and counts, then truncates one entry and binds that bucket
  again (a counted fallback to a fresh build). Each records the seconds
  its server took to bind its ladder (``ready_s``).

    python -m mxnet_tpu_torch.tools.engine_phase restart first OUT.json \\
        [--device cuda] [--config JSON]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

from .lm import LM, lm_arg_params, lm_predict_symbol

ENGINE = {"serve_seq": 512, "buckets": (1, 2, 4), "swap_ladder": (2, 4),
          "rows": (1, 2), "requests": 16, "swap_after": 8,
          "decode_prompts": 3, "decode_new_tokens": 16,
          "restart_seq": 128, "restart_buckets": (1, 4),
          "restart_sizes": (1, 2, 4) * 3, "restart_min_samples": 6}
SEED = 0


def lm_serve_symbol(cfg, seq):
    """The LM's ``SoftmaxOutput`` head reshaped to (B, seq, vocab): the
    batch-major outputs ``InferenceServer`` slices by request."""
    from .. import symbol as sym

    return sym.Reshape(lm_predict_symbol(cfg), shape=(-1, seq, cfg["vocab"]))


def lm_requests(cfg, seq, sizes, seed):
    """Seeded (data, label) arrays, one request of each of ``sizes``
    rows."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, cfg["vocab"], (n, seq)).astype(np.float32),
             np.zeros((n, seq), np.float32)) for n in sizes]


def request_sizes(eng):
    """Rows of each server request: ``eng["rows"]`` in turn."""
    rows = eng["rows"]
    return [rows[i % len(rows)] for i in range(eng["requests"])]


def lm_server(cfg, seq, params, buckets, device, capture=False, fuse=False,
              adaptive=False, min_samples=64):
    """An ``InferenceServer`` (one replica on ``device``) over the LM at
    ``seq``, not started."""
    from .. import serving

    conf = serving.ServingConfig(
        buckets=tuple(buckets), max_delay_ms=0.0, replicas=1, warm=True,
        timeout_ms=600000.0, zero_copy=True, capture=capture, fuse=fuse,
        adaptive=adaptive, retune_interval=0,
        retune_min_samples=min_samples, program_budget=8)
    return serving.InferenceServer(
        lm_serve_symbol(cfg, seq).tojson(), params,
        {"data": (seq,), "softmax_label": (seq,)}, config=conf,
        devices=[device])


def serve_in_turn(srv, requests):
    """Each request's outputs, sent one after another."""
    return [srv.predict(data=x, softmax_label=y)[0] for x, y in requests]


def swap_ladder(srv, ladder):
    """Swap the server's ladder to ``ladder`` through its retune op (the
    tuner's proposal forced), and wait for it."""
    tuner = srv._tuner
    propose = tuner.propose
    tuner.propose = lambda hist, cur: list(ladder)
    try:
        srv.retune_now(wait=True)
    finally:
        tuner.propose = propose
    if tuple(srv.current_ladder()) != tuple(ladder):
        raise RuntimeError("the ladder swap to %s left %s"
                           % (ladder, srv.current_ladder()))


def digest(a) -> str:
    """sha256 of an array's type, shape and bytes: equal digests are
    equal outputs bit for bit."""
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(("%s%s" % (a.dtype, a.shape)).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def restart_main(role, out, device, cfg, eng, seed=SEED):
    """One process of the warm restart (see the module's docstring)."""
    import torch

    from .. import engine, predict, progcache
    from ..analysis import compile_witness as witness
    from ..ops.kernels import flash_attention as fa

    witness.enable(True)
    seq = eng["restart_seq"]
    params = lm_arg_params(cfg, seed)
    reqs = lm_requests(cfg, seq, eng["restart_sizes"], seed + 30)
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    srv = lm_server(cfg, seq, params, eng["restart_buckets"], device,
                    adaptive=True, min_samples=eng["restart_min_samples"])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    rec = {"role": role, "engine": type(engine.get()).__name__,
           "ready_s": time.perf_counter() - t0,
           "ladder_at_start": list(srv.current_ladder()),
           "disk_loads_at_start": predict.disk_load_count(),
           "compiles_at_start": witness.compiles_total()}
    with srv:
        if role == "first":
            serve_in_turn(srv, reqs)
            srv.retune_now(wait=True)
            rec["ladder"] = list(srv.current_ladder())
        outs = serve_in_turn(srv, reqs)
        rec["ladder_served"] = list(srv.current_ladder())
        rec["cache"] = srv.cache_stats()
    rec.update(disk_loads=predict.disk_load_count(),
               binds=predict.compile_count(),
               compiles=witness.compiles_total(),
               witness=witness.compile_witness_report()["compiles"],
               witness_disk_loads=witness.disk_loads_total(),
               flash_launches=fa.flash_attention.launches,
               progcache=progcache.stats(),
               digests=[digest(o) for o in outs])
    if role == "second":
        # one entry cut short: the bind falls back to a fresh build (and
        # stores it again) with the same outputs
        base = srv._replicas[0].cache
        big = max(base.buckets)
        key = base._bucket_key(base._model_fp(), big)
        path = os.path.join(progcache.cache_dir(), key + ".prog")
        with open(path, "rb") as f:
            blob = f.read()
        with open(path, "wb") as f:
            f.write(blob[:len(blob) // 2])
        before = progcache.stats()["fallbacks"]
        p = base._base.reshape({"data": (big, seq),
                                "softmax_label": (big, seq)})
        i = next(i for i, n in enumerate(eng["restart_sizes"]) if n == big)
        got = p.forward(data=reqs[i][0], softmax_label=reqs[i][1])[0]
        rec["truncated"] = {
            "bucket": big, "source": p.progcache_source,
            "fallbacks": progcache.stats()["fallbacks"] - before,
            "same_outputs": digest(got.asnumpy()) == digest(outs[i])}
    with open(out, "w") as f:
        json.dump(rec, f)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("restart")
    r.add_argument("role", choices=("first", "second"))
    r.add_argument("out")
    r.add_argument("--device", default="cuda")
    r.add_argument("--config", default=None,
                   help="JSON {\"lm\": {...}, \"engine\": {...}} in place "
                        "of LM / ENGINE")
    args = ap.parse_args(argv)
    conf = json.loads(args.config) if args.config else {}
    eng = dict(ENGINE, **conf.get("engine", {}))
    restart_main(args.role, args.out, args.device, conf.get("lm", LM), eng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
