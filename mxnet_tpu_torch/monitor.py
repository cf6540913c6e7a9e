"""Monitor: statistics of a training run's arrays, every ``interval``
batches.

Counterpart of ``mxnet_tpu/monitor.py`` (reference python/mxnet/
monitor.py). ``install(exe)`` sets the executor's monitor callback: on a
monitored batch (``tic`` at a multiple of ``interval`` activates it) the
executor evaluates every internal output of its graph, arguments
included, and hands each to the callback, which keeps ``stat_func`` of
those whose name matches ``pattern``; ``toc`` adds the arguments after the
update and returns (step, name, statistic as text), sorted by name with
``sort``. The default statistic is ``norm(x) / sqrt(x.size)``.

One divergence: the JAX package computes each statistic later on an
engine worker, reading an immutable array. Here the arrays are updated in
place, so the statistic is computed when the callback is called, on the
caller's thread, in the device's stream order (its kernels queue behind
the step's; nothing waits for them until ``toc`` reads them).

Telemetry (domain ``monitor``, the reference's names): each statistic
inside a ``monitor.stat`` span, the wait for them inside
``monitor.drain``.
"""
from __future__ import annotations

import logging
import re
from math import sqrt

import torch

from . import ndarray as nd
from . import telemetry
from .ndarray import NDArray


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                return nd.norm(x) / sqrt(x.size)

            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

        def stat_helper(name, arr):
            if not self.activated or not self.re_prog.match(name):
                return
            self._stat(name, arr)

        # an executor skips the internal outputs' evaluation while idle
        stat_helper.is_active = lambda: self.activated
        self.stat_helper = stat_helper

    def _stat(self, name, arr):
        with telemetry.span("monitor.stat", domain="monitor", stat=name):
            self.queue.append((self.step, name, self.stat_func(arr)))

    def _drain(self):
        """Wait for the statistics' kernels on every installed executor's
        device."""
        with telemetry.span("monitor.drain", domain="monitor",
                            n_exes=len(self.exes)):
            for dev in {exe._device for exe in self.exes}:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)

    def install(self, exe):
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        if self.step % self.interval == 0:
            self._drain()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        if not self.activated:
            return []
        for exe in self.exes:
            for name, array in zip(exe._symbol.list_arguments(),
                                   exe.arg_arrays):
                if self.re_prog.match(name):
                    self._stat(name, array)
        self._drain()
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            s = ""
            for v in v_list:
                if v.shape in ((1,), ()):
                    s += str(v.asscalar()) + "\t"
                else:
                    s += str(v.asnumpy()) + "\t"
            res.append((n, k, s))
        self.queue = []
        return res

    def toc_print(self):
        for n, k, v in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, v)
