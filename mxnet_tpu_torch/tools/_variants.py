"""What the kernel-variant tools share (:mod:`.wgrad_variants`,
:mod:`.lstm_variants`, :mod:`.flash_fwd_ablate`): a kernel's source with
text edits, built with the port's nvcc flags beside the ``csrc`` headers it
includes into ``mxnet_tpu_torch/_build/variants/<kernel>/<variant>/`` (one
nvcc each, all started together), launched through the wrapper's own C
entry in place of the kernel's library, and timed by the profiler's device
time.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess

from ..ops.kernels import _build


def edited(kernel: str, name: str, edits) -> str:
    """``csrc/<kernel>.cu`` with variant ``name``'s ``edits`` ([(text,
    replacement)]); raises if a text does not occur exactly once (the
    source moved on)."""
    with open(os.path.join(_build.CSRC, kernel + ".cu")) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError("variant %s: %r occurs %d times in the source"
                             % (name, old, text.count(old)))
        text = text.replace(old, new)
    return text


def build(kernel: str, sources):
    """Build ``sources`` ({variant: its ``kernel`` source}); returns
    variant -> (library path, the nvcc / ptxas log)."""
    procs, out = [], {}
    for name, text in sources.items():
        d = os.path.join(_build.BUILD_DIR, "variants", kernel, name)
        os.makedirs(d, exist_ok=True)
        for header in _build.inputs(kernel):
            if header != kernel + ".cu":
                shutil.copy(os.path.join(_build.CSRC, header), d)
        src = os.path.join(d, kernel + ".cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(d, kernel + ".so")
        procs.append((name, lib, subprocess.Popen(
            [_build.nvcc()] + _build.NVCC_FLAGS + ["-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, log))
        out[name] = (lib, log)
    return out


def forget(kernel: str):
    """Drop ``kernel``'s library and its C entries (``mxtt_<kernel>*``)
    from the wrappers' caches."""
    _build._libs.pop(kernel, None)
    for symbol in [s for s in _build._fns if s.startswith("mxtt_" + kernel)]:
        _build._fns.pop(symbol)


@contextlib.contextmanager
def loaded(kernel: str, path: str):
    """``kernel``'s wrapper launches the library at ``path`` inside the
    block."""
    forget(kernel)
    _build._libs[kernel] = ctypes.CDLL(path)
    try:
        yield
    finally:
        forget(kernel)


def device_ms_by(fn, parts=(), reps=20, warmup=3):
    """Device time (ms) of one ``fn()`` call, and {part: ms} of the kernels
    whose names hold each of ``parts``, from a profiler trace of ``reps``
    calls; a trace with no device time is taken again (three at most)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _attempt in range(3):
        with torch.profiler.profile(activities=acts) as p:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in p.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in events)
        if total > 0:
            return total / reps / 1e3, {
                part: sum(e.self_device_time_total for e in events
                          if part in e.key) / reps / 1e3 for part in parts}
    raise RuntimeError("the profiler saw no device time")
