"""Spans around calls into the program, and the reduction of a
`torch.profiler` trace to device busy time, idle gaps and kernel times.

Spans are ``record_function`` ranges opened by the benchmark's own code:
``call`` around each API call, ``client`` around the client's work
between calls, and, in a traced run, wrappers around the program's
module functions that each layer is entered through (`LAYER_SPANS`).  A
wrapper whose function the program no longer has is left out.  Nothing
is added inside the program, and nothing is written to disk: the trace
is read in memory when the window closes.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib

import torch

WINDOW = "window"
CALL = "call"
CLIENT = "client"
OUTSIDE = "harness"

#: (module, function, span): the program's functions that each layer is
#: entered through, wrapped in a traced run
LAYER_SPANS = [
    ("pyopal_tpu_torch.ops.engine", "search_scores_batch", "engine"),
    ("pyopal_tpu_torch.ops.engine", "_search_long_kernels", "engine.long"),
    ("pyopal_tpu_torch.ops.packing", "pack_database_slice_flat", "pack"),
    ("pyopal_tpu_torch.ops.engine", "_profiles_q8", "profile"),
    ("pyopal_tpu_torch.ops.engine", "_profiles_for_cohort", "profile"),
    ("pyopal_tpu_torch.ops.ragged", "make_profiles_host", "profile"),
    ("pyopal_tpu_torch.ops.q8", "search_flat_q8", "launch.q8"),
    ("pyopal_tpu_torch.ops.ragged", "search_flat", "launch.ragged"),
    ("pyopal_tpu_torch.ops.engine", "_assemble_flat", "assemble"),
    ("pyopal_tpu_torch.ops.engine", "_assemble_flat_q8", "assemble"),
    ("pyopal_tpu_torch.ops.engine", "build_score_results", "results"),
    ("pyopal_tpu_torch.parallel.sharded_flat", "sharded_search_flat", "sharded"),
    ("pyopal_tpu_torch.parallel.sharded_flat", "pack_flat_sharded", "pack"),
    ("pyopal_tpu_torch.parallel.sharded_flat", "_gather_host", "gather"),
]


def _wrap(fn, name):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def layer_spans(enabled: bool):
    """Wrap the program's layer entry points in spans while inside."""
    undo = []
    if enabled:
        for mod_name, attr, name in LAYER_SPANS:
            try:
                mod = importlib.import_module(mod_name)
            except ImportError:
                continue
            fn = getattr(mod, attr, None)
            if fn is None:
                continue
            setattr(mod, attr, _wrap(fn, name))
            undo.append((mod, attr, fn))
    try:
        yield
    finally:
        for mod, attr, fn in reversed(undo):
            setattr(mod, attr, fn)


def span(enabled: bool, name: str):
    if enabled:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class Profiler:
    """A `torch.profiler` session over the measured window."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def events(self):
        """``(name, is_device, start_ns, end_ns, card)`` of every event;
        ``card`` is a device event's card index, 0 for the host's."""
        out = []
        for e in self._prof.profiler.kineto_results.events():
            dev = e.device_type() != torch.autograd.DeviceType.CPU
            if dev and e.is_user_annotation():
                continue
            start = int(e.start_ns())
            card = max(int(e.device_index()), 0) if dev else 0
            out.append(
                (e.name(), dev, start, start + int(e.duration_ns()), card)
            )
        return out


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


class Busy:
    """The union of device activity, with the time it covers inside any
    interval."""

    def __init__(self, intervals):
        self.iv = _merge(intervals)
        self.starts = [a for a, _ in self.iv]
        self.cum = [0]
        for a, b in self.iv:
            self.cum.append(self.cum[-1] + (b - a))

    def _upto(self, t):
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0
        a, b = self.iv[i - 1]
        return self.cum[i - 1] + (min(t, b) - a)

    def within(self, a, b) -> int:
        return self._upto(b) - self._upto(a) if b > a else 0


def short_name(name: str) -> str:
    """A device operation's name without its argument list, and without
    its template arguments where they are long."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i].rstrip()
            break
    if len(name) > 64 and "<" in name:
        name = name[: name.index("<")]
    return name


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


class Summary:
    """What the readers take from a traced window (times in seconds).

    Busy and kernel time are kept card by card, over the cell's
    ``chips`` cards (more where the trace shows more), a card that ran
    nothing idle all through: ``card_busy_s`` and ``card_kernel_s``;
    ``busy_s`` is the mean card's busy time and ``kernel_s`` the sum of
    the cards' kernel times.  The calls' busy time and the idle gaps
    take the union of all cards, the host's view: time in which no card
    works.  On one card the two views are one.
    """

    def __init__(self, events, span_names, chips=1):
        windows = [e for e in events if not e[1] and e[0] == WINDOW]
        if not windows:
            raise ValueError("the trace holds no window span")
        w0, w1 = windows[0][2], windows[0][3]
        device = [e for e in events if e[1] and e[3] > w0 and e[2] < w1]
        clip = [(max(a, w0), min(b, w1)) for _, _, a, b, _ in device]
        busy = Busy(clip)
        cards = max([chips] + [e[4] + 1 for e in device])
        busy_ns, kernel_ns = [], []
        for c in range(cards):
            on = [(e, iv) for e, iv in zip(device, clip) if e[4] == c]
            busy_ns.append(Busy([iv for _, iv in on]).within(w0, w1))
            kernel_ns.append(
                Busy([iv for e, iv in on if is_kernel(e[0])]).within(w0, w1)
            )
        self.window_s = (w1 - w0) / 1e9
        self.card_busy_s = [x / 1e9 for x in busy_ns]
        self.card_kernel_s = [x / 1e9 for x in kernel_ns]
        self.busy_s = sum(busy_ns) / 1e9 / cards
        self.kernel_s = sum(kernel_ns) / 1e9
        self.device_ops = {}
        for name, _, a, b, _ in device:
            name = short_name(name)
            self.device_ops[name] = self.device_ops.get(name, 0.0) + (b - a) / 1e9
        spans = sorted(
            (e for e in events if not e[1] and e[0] in span_names and e[0] != WINDOW),
            key=lambda e: (e[2], -e[3]),
        )
        calls = [e for e in spans if e[0] == CALL]
        self.calls = len(calls)
        self.call_s = [(b - a) / 1e9 for _, _, a, b, _ in calls]
        self.call_busy_s = [busy.within(a, b) / 1e9 for _, _, a, b, _ in calls]
        self.idle_gaps = _idle_by_span(busy, spans, w0, w1)


def _idle_by_span(busy, spans, w0, w1):
    """Device-idle time inside the window, by the innermost benchmark
    span open on the host meanwhile (`OUTSIDE` where none is)."""
    cuts = {w0, w1}
    for _, _, a, b, _ in spans:
        cuts.add(min(max(a, w0), w1))
        cuts.add(min(max(b, w0), w1))
    for a, b in busy.iv:
        if w0 < a < w1:
            cuts.add(a)
        if w0 < b < w1:
            cuts.add(b)
    points = sorted(cuts)
    # spans nest on the host's one thread: a stack, swept in time order
    opens = sorted(spans, key=lambda e: (e[2], -e[3]))
    out, stack, k = {}, [], 0
    for a, b in zip(points, points[1:]):
        while stack and stack[-1][3] <= a:
            stack.pop()
        while k < len(opens) and opens[k][2] <= a:
            if opens[k][3] > a:
                while stack and stack[-1][3] <= opens[k][2]:
                    stack.pop()
                stack.append(opens[k])
            k += 1
        while stack and stack[-1][3] <= a:
            stack.pop()
        idle = (b - a) - busy.within(a, b)
        if idle > 0:
            name = stack[-1][0] if stack else OUTSIDE
            out[name] = out.get(name, 0.0) + idle / 1e9
    return out


def top(d: dict, n: int = 10):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def span_names():
    return {WINDOW, CALL, CLIENT} | {name for _, _, name in LAYER_SPANS}
