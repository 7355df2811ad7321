"""The trace reduction card by card: on one card every reading equals
that of the reduction before readings were kept by card (a frozen copy
below), and on four cards busy and kernel time are summed card by card
while the calls' busy time and the idle gaps keep the union."""

import bisect
import importlib.util
import random
from types import SimpleNamespace

import pytest

from benchmark import peaks, tracing
from benchmark.tests import fixture_cell

MS = 1_000_000


def reader(name):
    path = fixture_cell.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "c_" + name.replace(".", "_"), path
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- a frozen copy of the one-card reduction (events without a card) --

def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


class _Busy:
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

    def within(self, a, b):
        return self._upto(b) - self._upto(a) if b > a else 0


def _idle_by_span(busy, spans, w0, w1):
    cuts = {w0, w1}
    for _, _, a, b in spans:
        cuts.add(min(max(a, w0), w1))
        cuts.add(min(max(b, w0), w1))
    for a, b in busy.iv:
        if w0 < a < w1:
            cuts.add(a)
        if w0 < b < w1:
            cuts.add(b)
    points = sorted(cuts)
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
            name = stack[-1][0] if stack else tracing.OUTSIDE
            out[name] = out.get(name, 0.0) + idle / 1e9
    return out


class OneCardSummary:
    def __init__(self, events, span_names):
        w = [e for e in events if not e[1] and e[0] == tracing.WINDOW][0]
        w0, w1 = w[2], w[3]
        device = [e for e in events if e[1] and e[3] > w0 and e[2] < w1]
        clip = [(max(a, w0), min(b, w1)) for _, _, a, b in device]
        busy = _Busy(clip)
        kernels = _Busy(
            [iv for e, iv in zip(device, clip) if tracing.is_kernel(e[0])]
        )
        self.window_s = (w1 - w0) / 1e9
        self.busy_s = busy.within(w0, w1) / 1e9
        self.kernel_s = kernels.within(w0, w1) / 1e9
        self.device_ops = {}
        for name, _, a, b in device:
            name = tracing.short_name(name)
            self.device_ops[name] = self.device_ops.get(name, 0.0) + (b - a) / 1e9
        spans = sorted(
            (e for e in events
             if not e[1] and e[0] in span_names and e[0] != tracing.WINDOW),
            key=lambda e: (e[2], -e[3]),
        )
        calls = [e for e in spans if e[0] == tracing.CALL]
        self.calls = len(calls)
        self.call_s = [(b - a) / 1e9 for _, _, a, b in calls]
        self.call_busy_s = [busy.within(a, b) / 1e9 for _, _, a, b in calls]
        self.idle_gaps = _idle_by_span(busy, spans, w0, w1)


# -- synthetic traces --

def random_events(seed, cards=1):
    """A window of calls with nested layer spans and device events on
    ``cards`` cards, overlapping, some outside the window, at odd
    nanoseconds."""
    rng = random.Random(seed)
    w0, w1 = 1_000 + rng.randrange(MS), 400 * MS + rng.randrange(MS)
    out = [("window", False, w0, w1, 0)]
    t = w0 + rng.randrange(MS)
    while t < w1 - 10 * MS:
        d = rng.randrange(5 * MS, 40 * MS)
        out.append(("call", False, t, min(t + d, w1), 0))
        a = t + rng.randrange(d // 4)
        out.append(("engine", False, a, a + d // 2, 0))
        b = a + rng.randrange(d // 4)
        out.append(("launch.ragged", False, b, b + d // 8, 0))
        out.append(("client", False, t + d, t + d + MS // 3, 0))
        t += d + MS // 2 + rng.randrange(MS)
    names = ["pyopal::ragged_kernel<0, false>(int, int)", "void k(float*)",
             "Memcpy DtoH (Device -> Pageable)", "Memset (Device)"]
    for _ in range(400):
        a = rng.randrange(w0 - 20 * MS, w1 + 20 * MS)
        out.append((rng.choice(names), True, a, a + rng.randrange(1, 3 * MS),
                    rng.randrange(cards)))
    rng.shuffle(out)
    return out


def fake_run(summary, cells=9.1e12, db_bytes=146166984):
    return SimpleNamespace(
        trace=summary, cells=cells, db_bytes=db_bytes, calls=[],
    )


ONE_CARD_READERS = [
    "device_idle_pct.gcups", "device_idle_pct.query", "kernel_roofline.gcups",
    "kernel_roofline.query", "host_ms.gcups", "host_ms.query",
]


@pytest.mark.parametrize("seed", range(6))
def test_one_card_reads_as_before(seed):
    events = random_events(seed)
    names = tracing.span_names()
    new = tracing.Summary(events, names)
    old = OneCardSummary([e[:4] for e in events], names)
    for field in ("window_s", "busy_s", "kernel_s", "device_ops", "calls",
                  "call_s", "call_busy_s", "idle_gaps"):
        assert getattr(new, field) == getattr(old, field), field
    assert new.card_busy_s == [new.busy_s]
    assert new.card_kernel_s == [new.kernel_s]
    for name in ONE_CARD_READERS:
        assert reader(name)(fake_run(new)) == reader(name)(fake_run(old)), name
    assert reader("busiest_card_pct.gcups")(fake_run(new)) == 100.0


def four_card_events():
    # card 0 runs a kernel 10-50 ms and a copy 50-54 ms, card 1 a kernel
    # 20-40 ms, card 2 a kernel 60-70 ms, card 3 nothing
    return [
        ("window", False, 0, 100 * MS, 0),
        ("call", False, 0, 80 * MS, 0),
        ("client", False, 80 * MS, 100 * MS, 0),
        ("void k(int)", True, 10 * MS, 50 * MS, 0),
        ("Memcpy DtoH (Device -> Pageable)", True, 50 * MS, 54 * MS, 0),
        ("void k(int)", True, 20 * MS, 40 * MS, 1),
        ("void k(int)", True, 60 * MS, 70 * MS, 2),
    ]


def test_four_cards_card_by_card():
    s = tracing.Summary(four_card_events(), tracing.span_names(), chips=4)
    assert s.card_busy_s == pytest.approx([0.044, 0.020, 0.010, 0.0])
    assert s.card_kernel_s == pytest.approx([0.040, 0.020, 0.010, 0.0])
    assert s.busy_s == pytest.approx(0.074 / 4)
    assert s.kernel_s == pytest.approx(0.070)
    # the host's view: time in which any card works (10-54, 60-70 ms)
    assert s.call_busy_s == pytest.approx([0.054])
    assert s.idle_gaps["call"] == pytest.approx(0.080 - 0.054)
    assert s.idle_gaps["client"] == pytest.approx(0.020)
    run = fake_run(s, cells=peaks.CELLS_PER_S * 0.035, db_bytes=0)
    assert reader("device_idle_pct.gcups")(run) == pytest.approx(
        100 * (1 - 0.074 / 0.4)
    )
    assert reader("kernel_roofline.gcups")(run) == pytest.approx(50.0)
    assert reader("host_ms.gcups")(run) == pytest.approx(80 - 54)
    assert reader("busiest_card_pct.gcups")(run) == pytest.approx(
        100 * 40 / 70
    )


def test_a_card_that_ran_nothing_is_idle():
    events = [e for e in four_card_events() if not (e[1] and e[4] != 0)]
    s = tracing.Summary(events, tracing.span_names(), chips=4)
    assert s.card_busy_s[1:] == [0.0, 0.0, 0.0]
    assert reader("device_idle_pct.gcups")(fake_run(s)) == pytest.approx(
        100 * (1 - 0.044 / 0.4)
    )
    assert reader("busiest_card_pct.gcups")(fake_run(s)) == 100.0


def spread_over(cards, each_ms=20):
    """The same kernel work, ``4 x each_ms`` of one card's time, done by
    ``cards`` cards at once or by one card in turn."""
    ev = [("window", False, 0, 100 * MS, 0), ("call", False, 0, 100 * MS, 0)]
    for k in range(4):
        a = 10 * MS if cards == 4 else (10 + k * each_ms) * MS
        ev.append(("void k(int)", True, a, a + each_ms * MS, k % cards))
    return tracing.Summary(ev, tracing.span_names(), chips=cards)


def test_busiest_card_even_and_one_card():
    assert reader("busiest_card_pct.gcups")(fake_run(spread_over(4))) == (
        pytest.approx(25.0)
    )
    one = [e[:4] + (0,) for e in four_card_events()]
    s = tracing.Summary(one, tracing.span_names(), chips=4)
    assert reader("busiest_card_pct.gcups")(fake_run(s)) == 100.0
    untraced = SimpleNamespace(trace=None)
    assert reader("busiest_card_pct.gcups")(untraced) is None


def test_roofline_reads_the_same_work_on_any_number_of_cards():
    cells = peaks.CELLS_PER_S * 0.04
    four = reader("kernel_roofline.gcups")(fake_run(spread_over(4), cells, 0))
    one = reader("kernel_roofline.gcups")(fake_run(spread_over(1), cells, 0))
    assert four == pytest.approx(one) == pytest.approx(50.0)
    # the union of the four cards would read four times as high
    assert spread_over(4).kernel_s == pytest.approx(0.08)


def test_more_cards_in_the_trace_than_the_cell_asks():
    ev = four_card_events()
    s = tracing.Summary(ev, tracing.span_names(), chips=1)
    assert len(s.card_busy_s) == 3
    assert s.kernel_s == pytest.approx(0.070)
