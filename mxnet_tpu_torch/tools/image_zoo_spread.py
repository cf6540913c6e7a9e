"""The yardsticks of the image zoo's and ssd's card-vs-CPU checks.

    python3 -m mxnet_tpu_torch.tools.image_zoo_spread [--seeds N] [model ...]
    python3 -m mxnet_tpu_torch.tools.image_zoo_spread --witness [model ...]

For each model of ``tools/image_zoo.py``'s ``IMAGE_ZOO["check"]`` (all by
default) at its published input, 1000 classes, Dropout at p = 0, and for
``ssd-vgg16`` (``tools/ssd.py``'s check: 300 x 300, 20 classes, batch 2,
the multibox metric's cross-entropy and smooth L1 in place of the
cross-entropy, no aux states):

- the spread (the default): the check of ``chip_smoke.py``'s image_zoo
  phase (``check_steps`` batches of ``check_batch``, SGD momentum, Xavier
  from the seed, the same seeded batches) twice on the CPU, in f32 and in
  f64, from the same f32 weights (``tools/resnet_spread.py``'s
  ``spread``), for the seeds ``SEED`` .. ``SEED + N - 1`` (N = 3), and
  after each batch the f32 run's distance from the f64 run in the measures
  the check gates on: the worst parameter update and aux state change (L2
  of the difference over the L2 of the f64 change; the shifts that only
  batch norms see, whose gradient is zero in exact arithmetic, left out:
  ``image_zoo.dead_shifts``) and the cross-entropy's relative difference.
  One JSON line a model, seed and batch, then one a model with the
  largest of each over the seeds (``"max_over_seeds"``). Full width:
  minutes on a many-core host.
- the witness (``--witness``, on a card): how far the library's f32
  convolutions lie from f64 on the card and on the CPU, without the port.
  Every convolution of the model's check (its input at ``check_batch``)
  with seeded data, weights and output gradient: ``F.conv2d`` (forward),
  ``torch.nn.grad.conv2d_input`` (dX) and, for the convolutions the port
  leaves to autograd (``ops.nn.takes_wgrad`` false),
  ``torch.nn.grad.conv2d_weight`` (dW), in f32 on the card (cuDNN, TF32
  off, ``cudnn.benchmark`` off: its heuristic picks one algorithm a shape,
  the one the port's calls get), in f32 on the card with cuDNN off
  (PyTorch's own GEMM convolution) and in f32 on the CPU, each against f64
  on the CPU. Each error is ||y32 - y64|| / ||y64||. One JSON line a
  model: the root mean square of the errors of each kind over its calls
  (a layer as often as it occurs) on each side, each kind's card-to-CPU
  ratio, ``ratio`` (the largest of the card's over the kinds) and the
  worst layers; ``chip_smoke.py`` widens the model's gates by ``ratio``
  where it exceeds 1.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .image_zoo import IMAGE_ZOO, dead_shifts, image_cfg, zoo_symbol
from .resnet import SEED, change_err
from .resnet_spread import spread
from .ssd import SSD, MultiBoxMetric, ssd_data, ssd_symbol

SSD_NAME = "ssd-vgg16"

SEEDS = 3


def zoo_spread(name, cfg=IMAGE_ZOO, seed=SEED):
    """Yield the f32-against-f64 distances of ``name``'s check on the CPU
    from ``seed``: a dict a batch (:func:`resnet_spread.spread`'s, with
    the model and the seed)."""
    run = image_cfg(cfg, cfg["check"][name])
    sym = zoo_symbol(name, cfg["classes"])
    for line in spread(run, seed, sym, skip=dead_shifts(sym)):
        yield dict(line, model=name, seed=seed)


def ssd_spread(cfg=SSD, seed=SEED):
    """Yield, a batch a dict, ssd's check (``check_steps`` batches of
    ``check_batch``, SGD momentum, Xavier from ``seed``, the seeded
    images and boxes of ``tools/ssd.py``) on the CPU in f32 against f64
    from the same f32 weights: the worst and median parameter update
    (:func:`resnet.change_err`) and the multibox metric's cross-entropy
    and smooth L1, each relative to the f64 run's."""
    from .. import initializer, optimizer

    sym = ssd_symbol(cfg)
    b, steps = cfg["check_batch"], cfg["check_steps"]
    x, y = ssd_data(cfg, b, steps, seed + 1)
    shapes = {"data": (b,) + tuple(cfg["image"]),
              "label": (b,) + tuple(y.shape[1:])}
    names = [n for n in sym.list_arguments() if n not in shapes]
    reqs = {n: ("null" if n in shapes else "write")
            for n in sym.list_arguments()}
    init = initializer.Xavier(factor_type="in", magnitude=2,
                              rng=np.random.RandomState(seed))
    exe32 = sym.simple_bind("cpu", grad_req=reqs, **shapes)
    for n in sorted(names):             # Module.init_params' draw order
        init(initializer.InitDesc(n), exe32.arg_dict[n])
    exe64 = sym.simple_bind("cpu", grad_req=reqs, type_dict={
        n: np.float64 for n in sym.list_arguments()}, **shapes)
    runs = []
    for exe in (exe32, exe64):
        for n in names:
            exe.arg_dict[n]._data.copy_(exe32.arg_dict[n]._data)
        opt = optimizer.SGD(learning_rate=cfg["lr"],
                            momentum=cfg["momentum"], wd=cfg["wd"],
                            rescale_grad=1.0 / b,
                            param_idx2name=dict(enumerate(names)))
        start = {n: exe.arg_dict[n].asnumpy().astype(np.float64)
                 for n in names}
        runs.append((exe, optimizer.Updater(opt), start))
    for step in range(steps):
        measures = []
        for exe, upd, _ in runs:
            exe.arg_dict["data"][:] = x[step * b:(step + 1) * b]
            exe.arg_dict["label"][:] = y[step * b:(step + 1) * b]
            exe.forward(is_train=True)
            exe.backward()
            upd.update_all((i, exe.grad_dict[n], exe.arg_dict[n])
                           for i, n in enumerate(names))
            metric = MultiBoxMetric()
            metric.update(None, exe.outputs)
            measures.append(dict(metric.get_name_value()))
        (e32, _, p32), (e64, _, p64) = runs
        upd = {n: change_err(e32.arg_dict[n].asnumpy() - p32[n],
                             e64.arg_dict[n].asnumpy() - p64[n])
               for n in names}
        worst = max(upd, key=upd.get)
        m32, m64 = measures
        yield {"model": SSD_NAME, "seed": seed, "batch": step + 1,
               "update_err_median": float(np.median(list(upd.values()))),
               "update_err_worst": upd[worst], "worst": worst,
               "aux_err_worst": 0.0,
               "ce_f32": m32["cross-entropy"], "ce_f64": m64["cross-entropy"],
               "ce_rel_err": abs(m32["cross-entropy"] - m64["cross-entropy"])
               / m64["cross-entropy"],
               "smooth_l1_rel_err": abs(m32["smooth_l1"] - m64["smooth_l1"])
               / m64["smooth_l1"]}


def max_over_seeds(lines):
    """The largest of each gated measure over the seeds' lines of one
    model: the worst update and aux change after batch 1, the
    cross-entropy after each batch; the form of ``chip_smoke.py``'s
    ``IMAGE_ZOO_SPREAD``."""
    first = [l for l in lines if l["batch"] == 1]
    steps = max(l["batch"] for l in lines)
    out = {"update": max(l["update_err_worst"] for l in first),
           "aux": max(l["aux_err_worst"] for l in first),
           "ce": tuple(max(l["ce_rel_err"] for l in lines
                           if l["batch"] == b) for b in range(1, steps + 1))}
    if "smooth_l1_rel_err" in first[0]:
        out["smooth_l1"] = tuple(max(l["smooth_l1_rel_err"] for l in lines
                                     if l["batch"] == b)
                                 for b in range(1, steps + 1))
    return out


def conv_calls(sym, image, batch):
    """Every Convolution of ``sym`` on ``batch`` images of ``image``:
    [(data shape, attrs)], a layer once for each time it occurs."""
    internals = sym.get_internals()
    # partial: a detector's label is not needed up to its convolutions
    _, outs, _ = internals.infer_shape_partial(data=(batch,) + tuple(image))
    shapes = dict(zip(internals.list_outputs(), outs))
    calls = []
    for node in sym._nodes():
        if node.is_var or node.op.name != "Convolution":
            continue
        src, i = node.inputs[0]
        if src.is_var:
            shape = (batch,) + tuple(image)
        else:
            shape = shapes["%s_%s" % (src.name,
                                      src.op.get_output_names(src.attrs)[i])]
        calls.append((tuple(shape), node.attrs))
    return calls


def _rel(y, ref):
    y, ref = y.double().cpu(), ref.double().cpu()
    return float((y - ref).norm() / ref.norm())


def conv_witness(name, cfg=IMAGE_ZOO, seed=SEED, device="cuda"):
    """The witness of ``name``'s check (module docstring): a dict of the
    root mean square errors by side (``card``, ``card_native``, ``cpu``)
    and kind (``fwd``, ``dgrad``, ``wgrad``), each kind's ratio to the
    CPU's, ``ratio`` and the worst layers. ``ssd-vgg16`` takes
    ``tools/ssd.py``'s check in place of ``cfg``."""
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight

    from ..ops.nn import takes_wgrad, _ntuple

    if name == SSD_NAME:
        sym = ssd_symbol(SSD)
        calls = conv_calls(sym, SSD["image"], SSD["check_batch"])
    else:
        side = cfg["check"][name]
        sym = zoo_symbol(name, cfg["classes"])
        calls = conv_calls(sym, (3, side, side), cfg["check_batch"])
    rng = np.random.RandomState(seed)
    sums, calls_of = {}, {}
    layers = []
    for shape, attrs in calls:
        k = _ntuple(attrs["kernel"], 2)
        stride = _ntuple(attrs["stride"], 2)
        dilate = _ntuple(attrs["dilate"], 2)
        pad = _ntuple(attrs["pad"], 2) if attrs["pad"] else (0, 0)
        groups = int(attrs["num_group"])
        c_out = int(attrs["num_filter"])
        w_shape = (c_out, shape[1] // groups) + k
        x64 = torch.from_numpy(rng.randn(*shape))
        w64 = torch.from_numpy(rng.randn(*w_shape)
                               * np.sqrt(2.0 / np.prod(w_shape[1:])))
        kw = dict(stride=stride, padding=pad, dilation=dilate, groups=groups)
        y64 = F.conv2d(x64, w64, **kw)
        dy64 = torch.from_numpy(rng.randn(*y64.shape))
        kinds = {"fwd": lambda x, w, dy: F.conv2d(x, w, **kw),
                 "dgrad": lambda x, w, dy: conv2d_input(x.shape, w, dy,
                                                        **kw)}
        if not takes_wgrad(attrs):
            kinds["wgrad"] = lambda x, w, dy: conv2d_weight(x, w.shape, dy,
                                                            **kw)
        row = {"data": list(shape), "kernel": list(k), "stride": list(stride),
               "pad": list(pad), "groups": groups, "num_filter": c_out}
        for kind, fn in kinds.items():
            calls_of[kind] = calls_of.get(kind, 0) + 1
            ref = fn(x64, w64, dy64)
            for where, dev, cudnn in (("card", device, True),
                                      ("card_native", device, False),
                                      ("cpu", "cpu", True)):
                with torch.backends.cudnn.flags(enabled=cudnn,
                                                benchmark=False,
                                                allow_tf32=False):
                    got = fn(*(t.float().to(dev) for t in (x64, w64, dy64)))
                err = _rel(got, ref)
                row["%s_%s" % (kind, where)] = err
                key = (where, kind)
                sums[key] = sums.get(key, 0.0) + err * err
        layers.append(row)
    rms = {where: {kind: float(np.sqrt(sums[(where, kind)] / calls_of[kind]))
                   for kind in calls_of}
           for where in ("card", "card_native", "cpu")}
    by_kind = {where: {kind: e / rms["cpu"][kind]
                       for kind, e in rms[where].items()}
               for where in ("card", "card_native")}
    worst = sorted(layers, key=lambda r: -max(
        r[k] / max(r[k.replace("_card", "_cpu")], 1e-300)
        for k in r if k.endswith("_card")))[:3]
    return {"model": name, "convolutions": len(calls), "rms": rms,
            "ratio_by_kind": by_kind, "ratio": max(by_kind["card"].values()),
            "worst_layers": worst}


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    torch.set_num_threads(min(8, torch.get_num_threads()))
    witness = "--witness" in args
    if witness:
        args.remove("--witness")
        torch.backends.cuda.matmul.allow_tf32 = False
    seeds = SEEDS
    if "--seeds" in args:
        i = args.index("--seeds")
        seeds = int(args[i + 1])
        del args[i:i + 2]
    for name in args or list(IMAGE_ZOO["check"]):
        if witness:
            print(json.dumps(conv_witness(name)), flush=True)
            continue
        lines = []
        for seed in range(SEED, SEED + seeds):
            for line in (ssd_spread(seed=seed) if name == SSD_NAME
                         else zoo_spread(name, seed=seed)):
                lines.append(line)
                print(json.dumps(line), flush=True)
        print(json.dumps({"model": name, "seeds": seeds,
                          "max_over_seeds": max_over_seeds(lines)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
