"""Throughput counters and profiler hooks.

Port of ``pyopal_tpu/utils/profiling.py``.  Upstream PyOpal has no
runtime tracing (debug builds use Cython linetrace,
``CythonExtension.cmake:40-58``); here the observability surface is:

- `gcups`: cell-updates-per-second accounting for a search call;
- `search_stats`: padding efficiency of a database's packed layout;
- `Timer`: a wall-clock timer that reports GCUPS;
- `trace`: context manager around `torch.profiler` that writes a Chrome
  trace (host and, where there is a card, CUDA activity) and the
  counters the traced calls added;
- `span`, `spanned` and `count`: the search path's own spans and
  counters, recorded only while a `torch.profiler` runs.

The spans are ``torch.profiler.record_function`` ranges named
``pyopal.<stage>``; they land in the profiler's trace beside the CUDA
kernels and copies, on the same clock.  The search path opens them
around its stages: ``pyopal.align`` / ``pyopal.align_batch`` /
``pyopal.align_arrays`` (a request), ``pyopal.encode``, ``pyopal.route``,
``pyopal.pack``, ``pyopal.profile``, ``pyopal.launch``,
``pyopal.assemble``, ``pyopal.copyback``, ``pyopal.scatter`` and
``pyopal.results``.  The counters are ``cells.needed`` (query residues
times target residues), ``cells.walked`` (the cells the kernels' walks
step through: whole passes of query rows times each warp's steps, see
`pyopal_tpu_torch.ops.ragged.walk_steps`), ``copyback.bytes``,
``profile.hits`` and ``profile.misses``; they are computed from
host-side shapes and lengths only, never from a device tensor.  With no
profiler running a span is a shared null context and a count does
nothing.  Kernel launches are counted, profiler or not, in the ``ops``
modules' ``launches`` and ``plain_calls``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

#: whether a profiler records on the calling thread (the C++ check)
_recording = torch.autograd._profiler_enabled
_NULL_SPAN = contextlib.nullcontext()
_COUNTERS: dict = {}
_COUNTERS_LOCK = threading.Lock()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records on this thread, else a shared null context."""
    if _recording():
        return torch.profiler.record_function(name)
    return _NULL_SPAN


def spanned(name: str):
    """Decorate a function to run inside a ``name`` span while a
    profiler records on the calling thread (`span`'s gate)."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if _recording():
                with torch.profiler.record_function(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)

        return inner

    return wrap


def counting() -> bool:
    """Whether a `torch.profiler` runs in this process.

    The flag is the process's, not the thread's: ``align(threads>=2)``
    searches from `ThreadPool` workers, on which a profiler started by
    the caller records no span, yet whose work counts.
    """
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while a profiler runs."""
    if counting():
        with _COUNTERS_LOCK:
            _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


def counters() -> dict:
    """A snapshot of the counters."""
    with _COUNTERS_LOCK:
        return dict(_COUNTERS)


def reset_counters() -> None:
    """Set every counter back to nothing."""
    with _COUNTERS_LOCK:
        _COUNTERS.clear()


def _launch_counts() -> dict:
    """The ``ops`` modules' launch and plain-version counts, flat:
    ``launches.<kernel>`` and ``plain_calls.<kernel>``."""
    from ..ops import group, q8, ragged, ragged_long, sweep, traceback

    out = {}
    for mod_name, mod in (("group", group), ("q8", q8), ("ragged", ragged),
                          ("ragged_long", ragged_long), ("sweep", sweep),
                          ("traceback", traceback)):
        for attr in ("launches", "plain_calls"):
            held = getattr(mod, attr, None)
            if isinstance(held, dict):
                out.update((f"{attr}.{k}", v) for k, v in held.items())
            elif held is not None:
                out[f"{attr}.{mod_name}"] = held
    return out


def gcups(query_len: int, total_target_residues: int, seconds: float) -> float:
    """Giga cell updates per second for one search pass."""
    if seconds is None:
        raise RuntimeError(
            "timer has not exited yet (seconds is unset)"
        )
    if seconds == 0.0:
        return float("inf")
    return query_len * total_target_residues / seconds / 1e9


def search_stats(database, start: int = 0, end: int | None = None) -> dict:
    """Packing efficiency stats for a database slice."""
    from ..ops import packing

    if start < 0:
        raise IndexError("database slice start cannot be negative")
    with database.lock.read:
        size = database.get_size()
        if end is None or end > size:
            end = size
        if end < start:
            raise IndexError("database slice end is lower than start")
        fp = packing.pack_database_slice_flat(database, start, end)
    true_cells = fp.total_cells
    padded = fp.total_cells_padded
    return {
        "n_targets": fp.n_targets,
        "n_blocks": fp.n_blocks,
        "residues": int(true_cells),
        "padded_cells": int(padded),
        "padding_overhead": float(padded / true_cells) if true_cells else 0.0,
    }


class Timer:
    """Wall-clock timer that reports GCUPS for a search workload.

    It reads the host's clock: the search calls return host results, so
    the device work of a call made inside it is inside the time.
    """

    def __init__(self, query_len: int, total_target_residues: int):
        self.query_len = query_len
        self.total = total_target_residues
        self.seconds = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0

    @property
    def gcups(self) -> float:
        return gcups(self.query_len, self.total, self.seconds)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a `torch.profiler` trace around a search and write it to
    ``logdir/trace.json`` (Chrome trace format), with what the counters
    and the ``ops`` modules' launch counts gained meanwhile in
    ``logdir/counters.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    before = {**counters(), **_launch_counts()}
    with profile(activities=activities) as prof:
        yield prof
    after = {**counters(), **_launch_counts()}
    gained = {
        k: v - before.get(k, 0)
        for k, v in sorted(after.items())
        if v != before.get(k, 0)
    }
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "counters.json"), "w") as f:
        json.dump(gained, f, indent=1)
