"""Profiler controls.

Counterpart of ``mxnet_tpu/profiler.py`` (reference python/mxnet/
profiler.py and src/engine/profiler.cc, which stamp per-op begin/end in
engine workers and dump chrome://tracing JSON). The host half of the
picture is :mod:`mxnet_tpu_torch.telemetry`'s span ring buffers
(engine, serving, executor); the device half is a ``torch.profiler``
trace over the same window, with the CPU activity of every thread and,
where a card is present, CUDA activity (every kernel the card ran, graph
replays included). ``dump_profile()`` merges both into ONE
chrome://tracing JSON at the configured ``filename``, the device events
moved onto the host spans' clock (``time.monotonic_ns``, in
microseconds), and ALWAYS writes that file, even with zero host spans.

On the card the trace opens and closes with a short spin kernel: a trace
that shows neither lost its device half, and ``dump_profile`` raises
rather than write a file without the device events it should hold. (The
spin kernels also keep a whole-run trace from losing the window's first
launch, which long runs have shown.) On the CPU the device half is the
CPU activity alone. The reference's engine per-op profile has no
counterpart: the engine's own spans (domain ``engine``) carry each op.
"""
from __future__ import annotations

import glob
import json
import logging
import os
import tempfile
import time

from . import telemetry
from .base import MXNetError

_log = logging.getLogger("mxnet_tpu_torch")

#: spin cycles of the kernel that opens and closes a trace on the card
_SPIN_CYCLES = 1000

_state = {"running": False, "dir": None, "filename": "profile.json",
          "prev_domains": None, "torch": None, "cuda": False,
          "events": None}


def profiler_set_config(mode="symbolic", filename="profile.json"):
    """(reference profiler.py profiler_set_config / MXSetProfilerConfig)."""
    del mode
    _state["filename"] = filename
    _state["dir"] = os.path.dirname(os.path.abspath(filename)) or "."


def _all_threads(torch):
    """A config that records the CPU activity of every thread (the engine
    worker runs the ops), or None where this PyTorch has no such switch:
    the CUDA activity covers every thread regardless."""
    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


def _spin(torch):
    torch.cuda._sleep(_SPIN_CYCLES)


def profiler_set_state(state="stop"):
    """(reference profiler.py profiler_set_state / MXSetProfilerState).

    ``'run'`` enables host telemetry spans (every domain unless
    ``MXNET_PROFILER`` names a subset) and starts a ``torch.profiler``
    trace (CPU activity, and CUDA activity where a card is present).
    ``'stop'`` ends the window; ``dump_profile()`` writes everything to
    one JSON file."""
    if state == "run" and not _state["running"]:
        import torch

        prev = telemetry.enabled_domains()
        _state["prev_domains"] = prev or None
        telemetry.enable_spans(os.environ.get("MXNET_PROFILER") or "all")
        telemetry.mark_begin("mxnet_profile", domain="profiler")
        acts = [torch.profiler.ProfilerActivity.CPU]
        cuda = torch.cuda.is_available()
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts,
                                      experimental_config=_all_threads(torch))
        prof.start()
        if cuda:
            _spin(torch)
        _state.update(running=True, torch=prof, cuda=cuda, events=None)
    elif state == "stop" and _state["running"]:
        import torch

        telemetry.mark_end("mxnet_profile", domain="profiler")
        prof, cuda = _state["torch"], _state["cuda"]
        if cuda:
            _spin(torch)
            torch.cuda.synchronize()
        prof.stop()
        _state["events"] = _torch_events(prof, cuda)
        _state.update(running=False, torch=None)
        if _state["prev_domains"]:
            telemetry.enable_spans(_state["prev_domains"])
        else:
            telemetry.disable_spans()


def _torch_events(prof, cuda):
    """The trace's chrome events with ``ts`` moved onto the host spans'
    clock. A trace with CUDA activity that holds no kernel event lost its
    device half: that raises."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="torch_trace_",
                                dir=_state["dir"])
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    # the trace's timestamps are microseconds of the wall clock less its
    # base; the host spans' are of time.monotonic_ns
    shift = (data.get("baseTimeNanoseconds", 0)
             - (time.time_ns() - time.monotonic_ns())) / 1000.0
    events = [e for e in data.get("traceEvents", []) if isinstance(e, dict)]
    for e in events:
        if isinstance(e.get("ts"), (int, float)):
            e["ts"] = e["ts"] + shift
    if cuda and not any(e.get("cat") == "kernel" for e in events):
        raise MXNetError("the profiler's trace holds no kernel event, not "
                         "even the spin kernels around its window: its "
                         "device half was lost")
    return events


def _ring_file_events(dirs):
    """Merge span ring files dumped by OTHER processes
    (``telemetry.dump_ring()`` writes ``telemetry_ring_<pid>.json``). Each
    file's events are already chrome-format; pid tags keep their rows
    apart, and trace-stamped spans join the same trace_id across
    processes. Files are consumed (removed), so a second dump sees only
    newer rings."""
    events = []
    seen = set()
    for d in dirs:
        if not d or d in seen:
            continue
        seen.add(d)
        for path in sorted(glob.glob(
                os.path.join(d, "telemetry_ring_*.json"))):
            try:
                with open(path) as f:
                    data = json.load(f)
                evs = (data if isinstance(data, list)
                       else data.get("traceEvents", [])
                       if isinstance(data, dict) else [])
                events.extend(e for e in evs if isinstance(e, dict))
                os.remove(path)
            except (OSError, ValueError):
                continue
    return events


def dump_profile() -> str:
    """(reference MXDumpProfile) Stop the window if running and write the
    merged chrome://tracing JSON at the configured ``filename``.

    Always writes (zero events included) and returns the absolute path.
    Host spans come from ``telemetry`` (drained: a second dump holds only
    newer ones), then other processes' ring files, then the last window's
    ``torch.profiler`` events (taken once)."""
    if _state["running"]:
        profiler_set_state("stop")
    path = os.path.abspath(_state["filename"])
    events = telemetry.chrome_events(clear=True)
    n_host = len(events)
    events.extend(_ring_file_events(
        [_state["dir"], os.environ.get("MXNET_TELEMETRY_RING_DIR")]))
    events.extend(_state["events"] or ())
    _state["events"] = None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    _log.info("profile dumped to %s (%d events, %d host spans)",
              path, len(events), n_host)
    return path


class TraceAnnotation:
    """A named region in the device half of the trace (the reference's
    jax.profiler.TraceAnnotation): ``torch.profiler.record_function``.
    Keyword arguments ride along as the region's argument string."""

    def __init__(self, name, **kwargs):
        import torch

        args = ",".join("%s=%s" % kv for kv in sorted(kwargs.items()))
        self._ctx = torch.profiler.record_function(name, args or None)

    def __enter__(self):
        return self._ctx.__enter__()

    def __exit__(self, *a):
        return self._ctx.__exit__(*a)
