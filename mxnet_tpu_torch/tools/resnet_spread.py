"""How far two f32 runs of the resnet card-vs-CPU check drift apart, on the
CPU.

    python3 -m mxnet_tpu_torch.tools.resnet_spread     # from the repo root

Runs the check of ``chip_smoke.py``'s resnet phase (``tools/resnet.py``:
ResNet-50 at ``check_batch`` for ``check_steps`` batches of SGD momentum,
Xavier from the seed, the same seeded batches) through ``simple_bind`` /
``forward`` / ``backward`` / ``Updater`` twice on the CPU, in f32 and in
f64, from the same f32 weights, and prints after each batch the f32 run's
distance from the f64 run in the measures the check gates on: for each
parameter ||update32 - update64|| / ||update64||, the same for each aux
state's change, and the cross-entropy's relative difference. Only f32
rounding separates the two runs, so this is the spread any two f32 orders
of summation (the card's and the CPU's) can show. One JSON line per batch.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .resnet import RESNET, SEED, change_err, resnet_data, resnet_symbol


def spread(cfg=RESNET, seed=SEED):
    """Yield one dict per batch: the f32 run against the f64 run."""
    from .. import initializer, optimizer

    sym = resnet_symbol(cfg)
    b, steps = cfg["check_batch"], cfg["check_steps"]
    shapes = {"data": (b,) + tuple(cfg["image"]), "softmax_label": (b,)}
    names = [n for n in sym.list_arguments() if n not in shapes]
    reqs = {n: ("null" if n in shapes else "write")
            for n in sym.list_arguments()}
    x, y = resnet_data(cfg, b, steps, seed + 1)
    init = initializer.Xavier(factor_type="in", magnitude=2,
                              rng=np.random.RandomState(seed))
    exe32 = sym.simple_bind("cpu", grad_req=reqs, **shapes)
    for n in sorted(names):             # Module.init_params' draw order
        init(initializer.InitDesc(n), exe32.arg_dict[n])
    for n, a in exe32.aux_dict.items():
        a[:] = 1.0 if n.endswith("var") else 0.0
    exe64 = sym.simple_bind("cpu", grad_req=reqs, type_dict={
        n: np.float64 for n in sym.list_arguments()}, **shapes)
    runs = []
    for exe in (exe32, exe64):
        for n in names:
            exe.arg_dict[n]._data.copy_(exe32.arg_dict[n]._data)
        for n, a in exe.aux_dict.items():
            a._data = exe32.aux_dict[n]._data.to(exe.arg_dict["data"]
                                                 ._data.dtype).clone()
        opt = optimizer.SGD(learning_rate=cfg["lr"],
                            momentum=cfg["momentum"], wd=cfg["wd"],
                            rescale_grad=1.0 / b,
                            param_idx2name=dict(enumerate(names)))
        start = ({n: exe.arg_dict[n].asnumpy().astype(np.float64)
                  for n in names},
                 {n: a.asnumpy().astype(np.float64)
                  for n, a in exe.aux_dict.items()})
        runs.append((exe, optimizer.Updater(opt), start))
    for step in range(steps):
        ce = []
        for exe, upd, _ in runs:
            exe.arg_dict["data"][:] = x[step * b:(step + 1) * b]
            exe.arg_dict["softmax_label"][:] = y[step * b:(step + 1) * b]
            exe.forward(is_train=True)
            exe.backward()
            upd.update_all((i, exe.grad_dict[n], exe.arg_dict[n])
                           for i, n in enumerate(names))
            prob = exe.outputs[0].asnumpy()[
                np.arange(b), y[step * b:(step + 1) * b].astype(int)]
            ce.append(float(-np.log(prob).mean()))
        (e32, _, (p32, a32)), (e64, _, (p64, a64)) = runs
        upd = {n: change_err(e32.arg_dict[n].asnumpy() - p32[n],
                             e64.arg_dict[n].asnumpy() - p64[n])
               for n in names}
        aux = {n: change_err(e32.aux_dict[n].asnumpy() - a32[n],
                             e64.aux_dict[n].asnumpy() - a64[n])
               for n in e32.aux_dict}
        worst = max(upd, key=upd.get)
        yield {"batch": step + 1, "update_err_median":
               float(np.median(list(upd.values()))),
               "update_err_worst": upd[worst], "worst": worst,
               "aux_err_median": float(np.median(list(aux.values()))),
               "aux_err_worst": max(aux.values()),
               "ce_f32": ce[0], "ce_f64": ce[1],
               "ce_rel_err": abs(ce[0] - ce[1]) / ce[1]}


def main() -> int:
    torch.set_num_threads(min(8, torch.get_num_threads()))
    for line in spread():
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
