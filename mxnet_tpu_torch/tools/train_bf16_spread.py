"""How far bf16 rounding alone moves the train phase's bf16 check, on the
CPU.

    python3 -m mxnet_tpu_torch.tools.train_bf16_spread    # from the repo root

Runs the bf16 check of ``chip_smoke.py``'s train phase (``tools/lm.py``:
the full-width LM at ``check_batch`` x ``check_seq``, the seeded weights
of ``lm_arg_params``, one seeded batch, ``check_steps`` SGD-momentum
steps through the fused step ``lm_train_step``) twice on the CPU, with
``compute_dtype`` "bfloat16" and in f32, and prints after each step the
bf16 run's distance from the f32 run in the measures the check gates on:
the loss's absolute difference and the largest absolute difference of
any parameter. The card's bf16 and the CPU's bf16 round the same values
at the same places but from sums in other orders; the check holds their
distance to ``TRAIN_BF16_LOSS`` (0.6, the losses) and
``TRAIN_BF16_SPREAD`` (1.5, the parameters) times this one, which it
computes itself from its own f32 run, and runs the card in f32 as a
control that must fail the loss gate. (On the CPU at a small size, the
port's bf16 lies from the JAX package's bf16 up to 1.12 times as far as
that package's bf16 lies from its f32: ``tests/test_torch_train_step.py``.)
One JSON line per step.
"""
from __future__ import annotations

import json
import sys

import numpy as np

from .lm import LM, SEED, TRAIN, lm_arg_params, lm_feed, lm_train_executor, \
    lm_train_step, lm_updater


def spread(cfg=LM, train=TRAIN, seed=SEED):
    """Yield one dict per step: the bf16 run against the f32 run."""
    params = lm_arg_params(cfg, seed)
    runs = []
    for dtype in ("bfloat16", None):
        exe, names = lm_train_executor(cfg, train["check_batch"],
                                       train["check_seq"], "cpu", dtype)
        exe.copy_params_from(params)
        lm_feed(exe, cfg, seed + 3)
        run, _ = lm_train_step(exe, names, lm_updater("sgd", train, names))
        runs.append((exe, names, run))
    for step in range(train["check_steps"]):
        losses, values = [], []
        for exe, names, run in runs:
            losses.append(float(run()[0]))
            values.append({n: exe.arg_dict[n].asnumpy() for n in names})
        dist = {n: float(np.abs(values[0][n] - values[1][n]).max())
                for n in values[1]}
        worst = max(dist, key=dist.get)
        yield {"step": step + 1, "loss_bf16": losses[0],
               "loss_f32": losses[1],
               "loss_abs_diff": abs(losses[0] - losses[1]),
               "param_max_abs_diff": dist[worst], "worst": worst}


def main() -> int:
    for line in spread():
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
