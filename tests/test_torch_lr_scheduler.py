"""mxnet_tpu_torch.lr_scheduler against the JAX package's, on the CPU.

Each scheduler's learning rate over updates 1..50 equals the JAX
package's exactly (the same host float arithmetic), including
``FactorScheduler``'s ``stop_factor_lr`` floor; the constructors refuse
what the reference refuses; an optimizer built with a scheduler reads it
at each update, in the Updater and in the fused step, whose lr tensor is
uploaded again when the value changes.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

SCHEDULERS = {
    "factor": lambda pkg: pkg.lr_scheduler.FactorScheduler(step=3,
                                                           factor=0.7),
    "factor_floor": lambda pkg: pkg.lr_scheduler.FactorScheduler(
        step=2, factor=0.5, stop_factor_lr=1e-3),
    "factor_one": lambda pkg: pkg.lr_scheduler.FactorScheduler(step=1),
    "multi": lambda pkg: pkg.lr_scheduler.MultiFactorScheduler(
        step=[4, 10, 11, 30], factor=0.3),
    "poly": lambda pkg: pkg.lr_scheduler.PolyScheduler(max_update=40,
                                                       base_lr=0.2, pwr=2),
    "poly_cubic": lambda pkg: pkg.lr_scheduler.PolyScheduler(
        max_update=25, base_lr=1.0, pwr=3),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_schedule_equals_the_jax_package(name):
    got, want = SCHEDULERS[name](mt), SCHEDULERS[name](mx)
    got.base_lr = want.base_lr = 0.1 if "poly" not in name else got.base_lr
    g = [got(n) for n in range(1, 51)]
    w = [want(n) for n in range(1, 51)]
    assert g == w
    if name == "factor_floor":
        assert g[-1] == 1e-3 and min(g) == 1e-3


def test_constructors_refuse_what_the_reference_refuses():
    ls = mt.lr_scheduler
    for bad in (lambda: ls.FactorScheduler(step=0),
                lambda: ls.FactorScheduler(step=2, factor=1.5),
                lambda: ls.MultiFactorScheduler(step=[3, 3]),
                lambda: ls.MultiFactorScheduler(step=[0, 2]),
                lambda: ls.MultiFactorScheduler(step=[2], factor=2.0),
                lambda: ls.MultiFactorScheduler(step=[])):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(NotImplementedError):
        ls.LRScheduler()(1)
    assert set(("LRScheduler", "FactorScheduler", "MultiFactorScheduler",
                "PolyScheduler")) <= set(dir(mt.lr_scheduler))


def test_updater_follows_the_schedule_like_the_jax_package():
    """SGD through each package's Updater on the same weight and
    gradients: the weights after each of 6 updates within 1e-6 (f32
    both sides), the schedule's base_lr set from learning_rate."""
    rng = np.random.RandomState(0)
    w0 = rng.uniform(-1, 1, (4, 3)).astype(np.float32)
    grads = [rng.uniform(-1, 1, (4, 3)).astype(np.float32) for _ in range(6)]
    out = {}
    for pkg, ctx in ((mx, None), (mt, "cpu")):
        sched = pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5)
        opt = pkg.optimizer.create("sgd", learning_rate=0.4, momentum=0.9,
                                   lr_scheduler=sched)
        assert sched.base_lr == 0.4
        upd = pkg.optimizer.get_updater(opt)
        w = pkg.nd.array(w0, ctx=ctx)
        hist = []
        for g in grads:
            upd(0, pkg.nd.array(g, ctx=ctx), w)
            hist.append((w.asnumpy().copy(), sched.base_lr))
        out[pkg] = hist
    for (tw, tl), (jw, jl) in zip(out[mt], out[mx]):
        assert tl == jl
        np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-6)
    assert [lr for _, lr in out[mt]] == [0.4, 0.4, 0.2, 0.2, 0.1, 0.1]


def test_fused_update_uploads_the_lr_when_the_schedule_moves_it():
    from mxnet_tpu_torch.optimizer import cached_lr_wd_arrays

    sched = mt.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    opt = mt.optimizer.create("sgd", learning_rate=1.0, lr_scheduler=sched)
    cache, seen, cpu = None, [], torch.device("cpu")
    for _ in range(3):
        opt._update_count(0)
        lr_arr, _, new = cached_lr_wd_arrays(
            cache, [opt.effective_lr_wd(0)], cpu)
        assert new is not cache          # the value moved: a new upload
        cache = new
        seen.append(float(lr_arr[0]))
        _, _, again = cached_lr_wd_arrays(cache, [opt.effective_lr_wd(0)],
                                          cpu)
        assert again is cache            # the same value: kept
    assert seen == [1.0, 0.5, 0.25]
