"""The LSTM LM trained data-parallel across processes: one rank's worker.

``chip_smoke.py`` (its ``dist`` phase) and the CPU tests start two of
these (``tools/dist_run.py``): each rank takes its share of every batch
of the run (rank r of n: rows [r * b / n, (r + 1) * b / n) of each batch
of b) and trains :mod:`.lstm_lm`'s model through ``Module.fit`` with a
``dist_sync`` kvstore: the collective store over ``parallel.dist``'s
group (``--backend``), or the parameter server when ``MXNET_TPU_PS_URI``
names one (a process started with the server role serves instead). Every rank
starts from the same Xavier draw; ``rescale_grad`` is 1 / (b / n * n), so
the run is the one-process fit at batch b.

Outputs, in ``--out``: ``probs<rank>.npy`` (each batch's probability of
the true label of every row of this rank, the numbers a Perplexity
metric reads: :func:`combined_perplexity` joins the ranks' in row
order), ``final<rank>.npz`` (the parameters after the run) and, with
``--states`` on rank 0, ``state<b>.npz`` before the first batch and after
each; one JSON line on stdout (launch counts, step ms, the kvstore's
counters and its push / pull ms a step). With ``--go FILE`` a rank sets up
(imports, the group, the model), writes ``ready<rank>`` and waits for
FILE before the fit, so a launcher can start the ranks early and time
the fit alone.

    python -m mxnet_tpu_torch.tools.dist_lstm --out DIR [--cfg JSON]
        [--device cpu] [--backend gloo] [--seed N] [--states] [--go FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .lstm_lm import LSTM_LM, SEED, lstm_data, lstm_symbol

#: the data-parallel run: the lstm phase's LM under SGD with momentum
DIST_LSTM = dict(LSTM_LM, lr=0.1, momentum=0.9, ranks=2)


def fit_args(cfg, init, metric):
    """``Module.fit`` keyword arguments: one epoch of SGD with momentum at
    ``cfg``'s rate, ``init``, ``metric``."""
    return {"num_epoch": 1, "optimizer": "sgd",
            "optimizer_params": (("learning_rate", cfg["lr"]),
                                 ("momentum", cfg["momentum"])),
            "initializer": init, "eval_metric": metric}


def rank_rows(batch, batches, rank, n):
    """Indices of rank ``rank``'s rows of ``batches`` batches of
    ``batch``, in order: its contiguous share of each batch."""
    share = batch // n
    return np.concatenate([np.arange(b * batch + rank * share,
                                     b * batch + (rank + 1) * share)
                           for b in range(batches)])


def label_probs_metric():
    """An EvalMetric keeping each update's probabilities of the true
    labels (``.probs``, one float32 array an update)."""
    from .. import metric

    class LabelProbs(metric.EvalMetric):
        def __init__(self):
            super().__init__("label_probs")
            self.probs = []

        def update(self, labels, preds):
            label = labels[0].asnumpy().reshape(-1).astype(np.int64)
            pred = preds[0].asnumpy()
            pred = pred.reshape(-1, pred.shape[-1])
            self.probs.append(pred[np.arange(label.size), label])
            self.sum_metric += 0.0
            self.num_inst += label.size

    return LabelProbs()


def combined_perplexity(probs_by_rank):
    """The Perplexity metric after each batch of the whole run, from the
    ranks' label probabilities (``probs_by_rank[r][b]``): the ranks' rows
    joined in order and summed as the metric sums one batch's."""
    from ..metric import Perplexity

    m, out = Perplexity(ignore_label=None), []
    for parts in zip(*probs_by_rank):
        p = np.concatenate(parts).astype(np.float32)
        m.update([np.zeros(p.size, np.float32)], [p.reshape(-1, 1)])
        out.append(m.get_name_value()[0][1])
    return out


def count_plain_calls():
    """On the host no kernel launches: count each plain-version call as a
    launch of its kernel, so a run on the CPU meets the card's launch
    arithmetic."""
    from ..ops.kernels import _launches
    from ..ops.kernels import fused_update as fu
    from ..ops.kernels import lstm as kl

    for mod, plain, launcher in ((kl, "lstm_step_plain", kl.lstm_step),
                                 (fu, "sgd_mom_update_plain",
                                  fu.sgd_mom_update),
                                 (fu, "sgd_mom_update_lr_plain",
                                  fu.sgd_mom_update_lr)):
        fn = getattr(mod, plain)

        def counted(*args, _fn=fn, _launcher=launcher, **kw):
            _launches.launched(_launcher, args[0].dtype)
            return _fn(*args, **kw)

        setattr(mod, plain, counted)


def _host_params(mod):
    args, _ = mod.get_params()
    return {n: a.asnumpy() for n, a in args.items()}


def run_worker(cfg, out, device=None, backend=None, seed=SEED,
               states=False, go=None):
    main_at = time.time()
    import torch

    from .. import initializer, io, telemetry
    from ..module import Module
    from ..ops.kernels import _launches
    from ..ops.kernels import fused_update as fu
    from ..ops.kernels import lstm as kl
    from ..parallel import dist

    ps = bool(os.environ.get("MXNET_TPU_PS_URI"))
    if ps:
        rank = int(os.environ["MXNET_TPU_WORKER_RANK"])
        n = int(os.environ["MXNET_TPU_NUM_WORKERS"])
    else:
        dist.init(backend=backend, device=device)
        rank, n = dist.rank(), dist.size()
    batch, batches = cfg["batch"], cfg["batches"]
    x, y = lstm_data(cfg, batch, batches, seed + 1)
    rows = rank_rows(batch, batches, rank, n)
    it = io.NDArrayIter(x[rows], y[rows], batch_size=batch // n)
    mod = Module(lstm_symbol(cfg), context=device)
    init = initializer.Xavier(rng=np.random.RandomState(seed))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(init)
    on_card = mod._context[0].type == "cuda"
    counters = (kl.lstm_step, fu.sgd_mom_update, fu.sgd_mom_update_lr)
    for c in counters:
        _launches.reset(c)
    telemetry.enable_spans("kvstore,executor")
    telemetry.drain_events()
    kv_before = dict(telemetry.registry.get_name_value())
    if states and rank == 0:
        np.savez(os.path.join(out, "state0.npz"), **_host_params(mod))
    marks = []

    def record(param):
        if on_card:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if states and rank == 0:
            np.savez(os.path.join(out, "state%d.npz" % len(marks)),
                     **_host_params(mod))
            marks[-1] = time.perf_counter()  # the save is not the step's

    metric = label_probs_metric()
    if go is not None:
        # set up: say so, and start when the launcher says go
        open(os.path.join(out, "ready%d" % rank), "w").close()
        deadline = time.time() + 600
        while not os.path.exists(go):
            if time.time() > deadline:
                raise SystemExit("no go file %s after 600 s" % go)
            time.sleep(0.005)
    ready_at = time.time()
    t0 = time.perf_counter()
    mod.fit(it, batch_end_callback=record, kvstore="dist_sync",
            **fit_args(cfg, init, metric))
    fit_done_at = time.time()
    kv_after = dict(telemetry.registry.get_name_value())
    events = telemetry.drain_events()
    telemetry.disable_spans()
    kv = mod._kvstore
    np.save(os.path.join(out, "probs%d.npy" % rank), np.stack(metric.probs))
    np.savez(os.path.join(out, "final%d.npz" % rank), **_host_params(mod))

    def span_ms(name):
        # complete events: (ph, name, domain, ts_ns, dur_ns, args)
        durs = [e[4] / 1e6 for e in events if e[1] == name and e[0] == "X"]
        return sum(durs) / max(len(marks), 1), len(durs)

    update_ms, updates = span_ms("model.update_params_on_kvstore")
    pull_ms, _ = span_ms("kvstore.pull")
    result = {
        "rank": rank, "workers": n, "kvstore": kv.type,
        "store": type(kv).__name__, "backend": dist.backend(),
        "device": str(mod._context[0]), "batch": batch // n,
        "batches": len(marks),
        "launches": {"lstm_step": kl.lstm_step.launches,
                     "sgd_mom_update": fu.sgd_mom_update.launches,
                     "sgd_mom_update_lr": fu.sgd_mom_update_lr.launches},
        "first_batch_ms": (marks[0] - t0) * 1e3 if marks else None,
        "step_ms": [(b - a) * 1e3 for a, b in zip(marks, marks[1:])],
        "update_on_kvstore_ms": update_ms, "update_spans": updates,
        "pull_ms": pull_ms,
        "kvstore_counters": {k: kv_after.get(k, 0) - kv_before.get(k, 0)
                             for k in kv_after
                             if k.startswith("kvstore_")},
        "fit_step": mod.fit_step_stats(),
        # wall-clock times (time.time()) for the launcher's breakdown
        "main_at": main_at, "ready_at": ready_at,
        "fit_done_at": fit_done_at}
    kv.barrier()
    if ps:
        kv.stop_server() if rank == 0 else kv.close()
    else:
        dist.shutdown()
    result["done_at"] = time.time()
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--cfg", default=None,
                        help="a JSON object updating DIST_LSTM")
    parser.add_argument("--device", default=None)
    parser.add_argument("--backend", default=None)
    parser.add_argument("--seed", type=int, default=SEED)
    parser.add_argument("--states", action="store_true")
    parser.add_argument("--go", default=None,
                        help="after set-up, write ready<rank> in --out and "
                             "wait for this file before the fit")
    parser.add_argument("--count-plain", action="store_true",
                        help="count plain-version calls as launches (a "
                             "run on the host)")
    args = parser.parse_args(argv)
    from .. import kvstore_server

    if kvstore_server.maybe_run_server_by_role():
        return 0
    if args.count_plain:
        count_plain_calls()
    cfg = dict(DIST_LSTM, **json.loads(args.cfg or "{}"))
    res = run_worker(cfg, args.out, args.device, args.backend, args.seed,
                     args.states, args.go)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
