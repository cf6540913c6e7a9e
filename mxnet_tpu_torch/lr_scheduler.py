"""Learning-rate schedulers.

Counterpart of ``mxnet_tpu/lr_scheduler.py`` (reference python/mxnet/
lr_scheduler.py). A scheduler maps the optimizer's update count to a
learning rate; ``Optimizer(lr_scheduler=...)`` sets its ``base_lr`` to the
optimizer's ``learning_rate`` and calls it at each update (``_get_lr``).
The values are host floats: the fused step uploads them to the card again
only when they change (``optimizer.cached_lr_wd_arrays``), so a captured
step's replays follow the schedule.
"""
from __future__ import annotations

import logging

_log = logging.getLogger("mxnet_tpu_torch")


class LRScheduler:
    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError()


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates, never below ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than "
                             "1 round")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr "
                             "reduce")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                _log.info("Update[%d]: now learning rate arrived at %0.5e, "
                          "will not change in the future", num_update,
                          self.base_lr)
            else:
                _log.info("Update[%d]: Change learning rate to %0.5e",
                          num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at each update milestone of the increasing list
    ``step``."""

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list of updates")
        for i, s in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise ValueError("Schedule step must be an increasing "
                                 "integer list")
            if s < 1:
                raise ValueError("Schedule step must be greater or equal "
                                 "than 1 round")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr "
                             "reduce")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
                _log.info("Update[%d]: Change learning rate to %0.5e",
                          num_update, self.base_lr)
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay of power ``pwr`` from ``base_lr`` to zero over
    ``max_update`` updates."""

    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        self.max_update = max_update
        self.power = pwr
        self.base_lr_orig = base_lr

    def __call__(self, num_update):
        if num_update <= self.max_update:
            self.base_lr = self.base_lr_orig * pow(
                1.0 - float(num_update) / float(self.max_update), self.power)
        return self.base_lr
