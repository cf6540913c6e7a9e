"""The full-width serving LM the card scripts drive.

``chip_smoke.py`` and :mod:`mxnet_tpu_torch.tools.profile_generate` serve
the GQA decoder LM of ``bench.py`` (d 2048, 16 heads, 4 kv heads,
ffn 8192, vocab 10000, bench.py's own 4 layers) from seeded random weights
in ``models/transformer.py`` checkpoint naming. Both take the
configuration, the weights and the card's identity line from here.
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
SEED = 0


def lm_arg_params(cfg, seed):
    """Seeded random weights in models/transformer.py checkpoint naming;
    matrices scaled 1/sqrt(fan_in) so the greedy argmax is well
    separated."""
    rng = np.random.default_rng(seed)
    d, f, v = cfg["d_model"], cfg["ffn"], cfg["vocab"]
    dkv = d // cfg["heads"] * cfg["kv_heads"]

    def mat(rows, cols):
        return rng.standard_normal((rows, cols), dtype=np.float32) \
            / np.float32(np.sqrt(cols))

    p = {"embed_weight": rng.standard_normal((v, d), dtype=np.float32)}
    for i in range(cfg["layers"]):
        pre = "layer%d" % i
        p[pre + "_ln1_gamma"] = np.ones(d, np.float32)
        p[pre + "_ln1_beta"] = np.zeros(d, np.float32)
        p[pre + "_q_weight"] = mat(d, d)
        p[pre + "_k_weight"] = mat(dkv, d)
        p[pre + "_v_weight"] = mat(dkv, d)
        p[pre + "_o_weight"] = mat(d, d)
        p[pre + "_ln2_gamma"] = np.ones(d, np.float32)
        p[pre + "_ln2_beta"] = np.zeros(d, np.float32)
        p[pre + "_ffn1_weight"] = mat(f, d)
        p[pre + "_ffn1_bias"] = np.zeros(f, np.float32)
        p[pre + "_ffn2_weight"] = mat(d, f)
        p[pre + "_ffn2_bias"] = np.zeros(d, np.float32)
    p["lnf_gamma"] = np.ones(d, np.float32)
    p["lnf_beta"] = np.zeros(d, np.float32)
    p["pred_weight"] = mat(v, d)
    p["pred_bias"] = np.zeros(v, np.float32)
    return p


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
