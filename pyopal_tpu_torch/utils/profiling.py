"""Throughput counters and profiler hooks.

Port of ``pyopal_tpu/utils/profiling.py``.  Upstream PyOpal has no
runtime tracing (debug builds use Cython linetrace,
``CythonExtension.cmake:40-58``); here the observability surface is:

- `gcups`: cell-updates-per-second accounting for a search call;
- `search_stats`: padding efficiency of a database's packed layout;
- `Timer`: a wall-clock timer that reports GCUPS;
- `trace`: context manager around `torch.profiler` that writes a Chrome
  trace (host and, where there is a card, CUDA activity).
"""

from __future__ import annotations

import contextlib
import os
import time


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
    ``logdir/trace.json`` (Chrome trace format)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
