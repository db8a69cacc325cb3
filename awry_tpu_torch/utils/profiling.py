"""Profiling helpers: the engine's spans and counters, and ``device_trace``.

``span(name)`` marks a part of the serving path.  While a ``torch.profiler``
runs it is a ``torch.profiler.record_function``, so the part lands in the
profiler's timeline as a user annotation, on the same clock as the kernels
and copies it launched; otherwise it costs one flag check and makes nothing.
``Counters`` is a dict of serving counters that client threads may add to
at once.  ``device_trace`` is a ``torch.profiler`` trace around a block of
work, exported as a Chrome trace (open it in Perfetto or chrome://tracing):
the spans show there above the kernels they launched.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str, ident=None):
    """A context manager over one part of the serving path, named
    ``name#ident`` (``name`` when ``ident`` is None).  With no profiler
    running it is a shared no-op: no ``RecordFunction`` is made and the name
    is not formatted.  The flag is the process's (a profiler started in one
    thread turns spans on in every thread; whether a thread's spans are
    recorded is the profiler's choice)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name if ident is None else f"{name}#{ident}")


class Counters(dict):
    """Named integer counters that several threads may add to at once: a
    dict (read, reset and printed as one) whose ``add`` holds a lock."""

    def __init__(self, names):
        super().__init__((name, 0) for name in names)
        self._lock = threading.Lock()

    def add(self, **deltas: int) -> None:
        with self._lock:
            for name, n in deltas.items():
                self[name] += n


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """A ``torch.profiler`` trace of the block: CUDA activity (beside the
    host ops that launch it) on a CUDA device, None meaning cuda:0, which
    raises without one; host activity alone for ``device="cpu"``.  Every
    thread's host ops and spans are recorded, not only this one's, so that
    engines served from client threads show.  Yields the profiler
    (``key_averages()`` and the like); on exit, after the card has finished
    the block's work, writes ``trace.<pid>.<ns>.json`` into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device("cuda", 0) if device is None else torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device_trace on {device}: no CUDA device is available")
        activities.append(ProfilerActivity.CUDA)
    elif device.type != "cpu":
        raise ValueError(f"device_trace traces a CUDA device or the CPU, not {device}")
    os.makedirs(log_dir, exist_ok=True)
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=activities, experimental_config=every_thread) as prof:
        try:
            yield prof
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json"))
