"""The full-width LM the card scripts drive.

``chip_smoke.py`` and :mod:`mxnet_tpu_torch.tools.profile_generate` serve
the GQA decoder LM of ``bench.py`` (d 2048, 16 heads, 4 kv heads,
ffn 8192, vocab 10000, bench.py's own 4 layers) from seeded random weights
in ``models/transformer.py`` checkpoint naming, and ``chip_smoke.py``
trains it (``TRAIN``: bench.py's SGD hyperparameters, batch cut from 32 to
4 x 2048 to fit the script's time). All take the configuration, the
weights and the card's identity line from here.
"""
from __future__ import annotations

import subprocess

import numpy as np

LM = {"vocab": 10000, "d_model": 2048, "heads": 16, "kv_heads": 4,
      "ffn": 8192, "layers": 4}
SERVE = {"slots": 4, "prefill_buckets": (128, 512, 2048),
         "max_context": 2304, "max_new_tokens": 32,
         "prompt_lens": (100, 300, 500, 900, 1500, 2000),
         "check_lens": (500, 2000)}
# bench.py:334's SGD hyperparameters; batch cut from bench's 32; the
# card-vs-CPU check runs 1 x 256 so its CPU side finishes in seconds
TRAIN = {"batch": 4, "seq": 2048, "sgd_steps": 5, "adam_steps": 3,
         "lr": 0.05, "momentum": 0.9, "wd": 1e-4, "adam_lr": 1e-4,
         "check_batch": 1, "check_seq": 256, "check_steps": 2}
SEED = 0


def lm_symbol(cfg):
    """The LM's training symbol (MakeLoss mean-NLL head, as bench.py)."""
    from .. import models

    return models.get_symbol(
        "transformer-lm", num_classes=cfg["vocab"], num_layers=cfg["layers"],
        num_heads=cfg["heads"], model_dim=cfg["d_model"],
        ffn_dim=cfg["ffn"], num_kv_heads=cfg["kv_heads"], scalar_loss=True)


def lm_train_executor(cfg, batch, seq, device=None):
    """The LM bound for training at (batch, seq) on ``device`` (None = the
    card): (executor, names of the trained arguments in bind order)."""
    sym = lm_symbol(cfg)
    reqs = {n: ("null" if n in ("data", "softmax_label") else "write")
            for n in sym.list_arguments()}
    exe = sym.simple_bind(device, grad_req=reqs, data=(batch, seq),
                         softmax_label=(batch, seq))
    return exe, [n for n in sym.list_arguments() if reqs[n] != "null"]


def lm_feed(exe, cfg, seed):
    """Put one seeded batch of token ids into ``exe``'s data and label
    (f32, as MXNet feeds them)."""
    rng = np.random.RandomState(seed)
    for n in ("data", "softmax_label"):
        exe.arg_dict[n][:] = rng.randint(
            0, cfg["vocab"], exe.arg_dict[n].shape).astype(np.float32)


def lm_updater(kind, train, names):
    """An ``optimizer.Updater`` with ``train``'s hyperparameters: ``kind``
    "sgd" (momentum) or "adam"."""
    from .. import optimizer

    idx2name = dict(enumerate(names))
    if kind == "sgd":
        opt = optimizer.SGD(learning_rate=train["lr"],
                            momentum=train["momentum"], wd=train["wd"],
                            param_idx2name=idx2name)
    else:
        opt = optimizer.Adam(learning_rate=train["adam_lr"], wd=train["wd"],
                             param_idx2name=idx2name)
    return optimizer.Updater(opt)


def lm_update(exe, names, updater):
    """A step's updates: one ``updater`` call per trained argument."""
    updater.update_all((i, exe.grad_dict[n], exe.arg_dict[n])
                       for i, n in enumerate(names))


def lm_train_setup(cfg, train, device=None, seed=SEED):
    """The start of the train run that ``chip_smoke.py`` and
    :mod:`mxnet_tpu_torch.tools.profile_train` drive: the LM bound at
    ``train``'s batch x seq on ``device`` (None = the card),
    ``Xavier(factor_type="in", magnitude=2)`` from ``seed``, one fixed
    batch from ``seed + 4``. Returns (executor, trained names)."""
    from .. import initializer

    exe, names = lm_train_executor(cfg, train["batch"], train["seq"], device)
    init = initializer.Xavier(factor_type="in", magnitude=2,
                              rng=np.random.RandomState(seed))
    for n in names:
        init(initializer.InitDesc(n), exe.arg_dict[n])
    lm_feed(exe, cfg, seed + 4)
    return exe, names


def lm_param_shapes(cfg):
    """name -> shape of every trained parameter, in checkpoint naming."""
    d, f, v = cfg["d_model"], cfg["ffn"], cfg["vocab"]
    dkv = d // cfg["heads"] * cfg["kv_heads"]
    shapes = {"embed_weight": (v, d)}
    for i in range(cfg["layers"]):
        pre = "layer%d" % i
        shapes.update({
            pre + "_ln1_gamma": (d,), pre + "_ln1_beta": (d,),
            pre + "_q_weight": (d, d), pre + "_k_weight": (dkv, d),
            pre + "_v_weight": (dkv, d), pre + "_o_weight": (d, d),
            pre + "_ln2_gamma": (d,), pre + "_ln2_beta": (d,),
            pre + "_ffn1_weight": (f, d), pre + "_ffn1_bias": (f,),
            pre + "_ffn2_weight": (d, f), pre + "_ffn2_bias": (d,)})
    shapes.update({"lnf_gamma": (d,), "lnf_beta": (d,),
                   "pred_weight": (v, d), "pred_bias": (v,)})
    return shapes


def lm_arg_params(cfg, seed):
    """Seeded random weights in models/transformer.py checkpoint naming;
    matrices scaled 1/sqrt(fan_in) so the greedy argmax is well
    separated, gammas 1, betas and biases 0."""
    rng = np.random.default_rng(seed)
    p = {}
    for name, shape in lm_param_shapes(cfg).items():
        if name == "embed_weight":
            p[name] = rng.standard_normal(shape, dtype=np.float32)
        elif name.endswith("_weight"):
            p[name] = rng.standard_normal(shape, dtype=np.float32) \
                / np.float32(np.sqrt(shape[1]))
        elif name.endswith("_gamma"):
            p[name] = np.ones(shape, np.float32)
        else:
            p[name] = np.zeros(shape, np.float32)
    return p


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
