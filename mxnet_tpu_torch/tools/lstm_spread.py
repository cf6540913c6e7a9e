"""How far two f32 runs of the lstm card-vs-CPU check drift apart, on the
CPU.

    python3 -m mxnet_tpu_torch.tools.lstm_spread       # from the repo root
    python3 -m mxnet_tpu_torch.tools.lstm_spread zoo   # each zoo optimizer

Runs the check of ``chip_smoke.py``'s lstm phase (``tools/lstm_lm.py``:
the full-width fused LSTM LM at ``check_batch`` for ``check_steps``
batches of plain SGD, Xavier from the seed, the same seeded batches)
through ``simple_bind`` / ``forward`` / ``backward`` / ``Updater`` twice on
the CPU, in f32 and in f64, from the same f32 weights, and prints after
each batch the f32 run's distance from the f64 run in the measures the
check gates on: for each parameter ||update32 - update64|| /
||update64|| (its change since the start), and the relative difference of
the perplexity over the batches so far. Only f32 rounding separates the
two runs, so this is the spread any two f32 orders of summation (the
card's and the CPU's) can show. One JSON line per batch. With ``zoo``,
the same for each optimizer run of ``tools/zoo.py`` but SGLD (whose noise
is drawn, not rounded), in the zoo phase's check: its hyperparameters,
each line naming its run.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .lstm_lm import LSTM_LM, SEED, lstm_data, lstm_symbol
from .resnet import change_err


def spread(cfg=LSTM_LM, seed=SEED, run=None):
    """Yield one dict per batch: the f32 run against the f64 run, under
    plain SGD at ``cfg["lr"]`` or the optimizer of the ``tools/zoo.py``
    run ``run``."""
    from .. import initializer, optimizer
    from .zoo import optimizer_run

    sym = lstm_symbol(cfg)
    b, steps = cfg["check_batch"], cfg["check_steps"]
    shapes = {"data": (b, cfg["seq"]), "softmax_label": (b, cfg["seq"])}
    names = [n for n in sym.list_arguments() if n not in shapes]
    reqs = {n: ("null" if n in shapes else "write")
            for n in sym.list_arguments()}
    x, y = lstm_data(cfg, b, steps, seed + 1)
    init = initializer.Xavier(rng=np.random.RandomState(seed))
    attrs = sym.attr_dict()
    exe32 = sym.simple_bind("cpu", grad_req=reqs, **shapes)
    for n in sorted(names):             # Module.init_params' draw order
        init(initializer.InitDesc(n, attrs.get(n)), exe32.arg_dict[n])
    exe64 = sym.simple_bind("cpu", grad_req=reqs, type_dict={
        n: np.float64 for n in sym.list_arguments()}, **shapes)
    runs = []
    for exe in (exe32, exe64):
        for n in names:
            exe.arg_dict[n]._data.copy_(exe32.arg_dict[n]._data)
        name, params = (("sgd", {"learning_rate": cfg["lr"]}) if run is None
                        else optimizer_run(run))
        opt = optimizer.create(name, rescale_grad=1.0 / b,
                               param_idx2name=dict(enumerate(names)),
                               **params)
        start = {n: exe.arg_dict[n].asnumpy().astype(np.float64)
                 for n in names}
        runs.append((exe, optimizer.Updater(opt), start, [0.0]))
    for step in range(steps):
        batch = slice(step * b, (step + 1) * b)
        for exe, upd, _, nll in runs:
            exe.arg_dict["data"][:] = x[batch]
            exe.arg_dict["softmax_label"][:] = y[batch]
            exe.forward(is_train=True)
            exe.backward()
            upd.update_all((i, exe.grad_dict[n], exe.arg_dict[n])
                           for i, n in enumerate(names))
            prob = exe.outputs[0].asnumpy()[
                np.arange(y[batch].size), y[batch].reshape(-1).astype(int)]
            nll[0] -= float(np.log(prob.astype(np.float64)).sum())
        (e32, _, p32, nll32), (e64, _, p64, nll64) = runs
        upd = {n: change_err(e32.arg_dict[n].asnumpy() - p32[n],
                             e64.arg_dict[n].asnumpy() - p64[n])
               for n in names}
        tokens = (step + 1) * y[batch].size
        ppl = [float(np.exp(v[0] / tokens)) for v in (nll32, nll64)]
        worst = max(upd, key=upd.get)
        yield {"run": run or "sgd", "batch": step + 1, "update_err": upd,
               "update_err_worst": upd[worst], "worst": worst,
               "perplexity_f32": ppl[0], "perplexity_f64": ppl[1],
               "perplexity_rel_err": abs(ppl[0] - ppl[1]) / ppl[1]}


def main(argv=None) -> int:
    from .zoo import ZOO, OPTIMIZERS

    argv = sys.argv[1:] if argv is None else argv
    torch.set_num_threads(min(8, torch.get_num_threads()))
    runs = ([(ZOO, r) for r, _, _ in OPTIMIZERS if r != "sgld"]
            if argv[:1] == ["zoo"] else [(LSTM_LM, None)])
    for cfg, run in runs:
        for line in spread(cfg, run=run):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
