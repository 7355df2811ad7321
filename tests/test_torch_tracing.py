"""The search path's spans and counters (`pyopal_tpu_torch.utils.profiling`):
where the ``pyopal.*`` spans open under a CPU `torch.profiler`, that
nothing is recorded or counted without one, and that the cell, byte and
profile-cache counters equal counts made by hand from the routing plan,
the packs' lane lengths and the walk's warps and passes."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pyopal_tpu_torch as pt
from pyopal_tpu_torch._align import _chunk_bounds
from pyopal_tpu_torch.ops import engine, packing, q8, ragged, ragged_long
from pyopal_tpu_torch.utils import profiling
import _torch_cpu  # noqa: F401  (torch threads: a worker's share)

LETTERS = "ARNDCQEGHILKMFPSTWYV"
STAGES = {
    "pyopal.encode", "pyopal.route", "pyopal.pack", "pyopal.profile",
    "pyopal.launch", "pyopal.assemble", "pyopal.copyback", "pyopal.scatter",
}
METHODS = ["align", "align_batch", "align_arrays"]
BATCHES = ["q8", "leftover", "long", "segmented"]


def _seq(rng, n):
    return "".join(rng.choice(list(LETTERS), int(n)))


@pytest.fixture(scope="module")
def db():
    rng = np.random.default_rng(11)
    return pt.Database([_seq(rng, n) for n in rng.integers(8, 60, 200)])


@pytest.fixture
def aligner():
    return pt.Aligner(device="cpu")


def _batch(kind, monkeypatch, seed=0):
    """Fresh queries of one route: 15 at tier 64 (a full and a partial q8
    group, K2), three K1 leftovers at tiers 64 and 128, or a query beyond
    K1's tiers (lowered to 64 rows) beside a short one, at its fine tier
    (K1) or in 32-row segments (K3)."""
    rng = np.random.default_rng([seed, BATCHES.index(kind)])
    if kind == "q8":
        return [_seq(rng, n) for n in rng.integers(33, 64, 15)]
    if kind == "leftover":
        return [_seq(rng, 30), _seq(rng, 50), _seq(rng, 90)]
    monkeypatch.setattr(ragged, "RAGGED_MAX_QPAD_STRIP", 64)
    if kind == "segmented":
        monkeypatch.setattr(ragged, "supports_fine", lambda *a: False)
        monkeypatch.setattr(ragged_long, "QSEG", 32)
    return [_seq(rng, 100), _seq(rng, 30)]


def _call(aligner, method, queries, db, **kw):
    """One request per query for `align`, one for the batch otherwise."""
    fn = getattr(aligner, method)
    if method == "align":
        return [fn(q, db, **kw) for q in queries]
    return fn(queries, db, **kw)


def _profiled(fn):
    """``fn()``'s result, its ``pyopal.`` events, and its counters with
    the launch and plain-version counts it added (as `trace` writes)."""
    profiling.reset_counters()
    before = profiling._launch_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [
        (e.name(), e.start_thread_id(), e.start_ns(),
         e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith("pyopal.")
    ]
    counted = profiling.counters()
    for k, v in profiling._launch_counts().items():
        if v != before[k]:
            counted[k] = v - before[k]
    return out, events, counted


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("method", METHODS)
def test_spans_nest_under_the_request(db, aligner, monkeypatch, method, batch):
    queries = _batch(batch, monkeypatch)
    _, events, _ = _profiled(lambda: _call(aligner, method, queries, db))
    root = f"pyopal.{method}"
    roots = [e for e in events if e[0] == root]
    assert len(roots) == (len(queries) if method == "align" else 1)
    inner = [e for e in events if e[0] != root]
    want = STAGES | ({"pyopal.results"} if method != "align_arrays" else set())
    assert {e[0] for e in inner} == want
    for name, tid, a, b in inner:
        assert any(
            t == tid and ra <= a and b <= rb for _, t, ra, rb in roots
        ), name


@pytest.mark.parametrize("method", METHODS)
def test_nothing_recorded_without_a_profiler(db, aligner, monkeypatch, method):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    assert profiling.span("pyopal.align") is profiling.span("pyopal.launch")
    assert isinstance(profiling.span("x"), type(profiling._NULL_SPAN))
    profiling.reset_counters()
    profiling.count("cells.needed", 5)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    for batch in ("q8", "long"):
        queries = _batch(batch, monkeypatch, seed=1)
        _call(aligner, method, queries, db, mode="end")
    assert not profiling.counting()
    assert profiling.counters() == {}


@pytest.mark.parametrize("batch", BATCHES)
def test_outputs_equal_with_and_without_profiler(db, aligner, monkeypatch,
                                                 batch):
    queries = _batch(batch, monkeypatch, seed=2)
    plain = aligner.align_arrays(queries, db, mode="end")
    traced, _, counted = _profiled(
        lambda: aligner.align_arrays(queries, db, mode="end")
    )
    assert counted["cells.walked"] > 0
    assert set(plain) == set(traced)
    for key in plain:
        np.testing.assert_array_equal(plain[key], traced[key])
    results = aligner.align_batch(queries, db, mode="end")
    traced, _, _ = _profiled(
        lambda: aligner.align_batch(queries, db, mode="end")
    )
    for a, b in zip(results, traced):
        assert [(r.score, r.query_end, r.target_end) for r in a] == [
            (r.score, r.query_end, r.target_end) for r in b
        ]


def _hand_steps(fp, G, pairs=False):
    """Steps of one pass over a pack's lanes, warp by warp: the ``32 //
    G`` lanes of a warp (``64 // G`` on K1's packed route, a pair of
    lanes a group) step to their longest target plus ``G - 1``, rounded
    up to even; a warp of empty lanes takes none."""
    lens = [int(x) for x in fp.lengths.reshape(-1)]
    per = 32 // G * (2 if pairs else 1)
    total = 0
    for w in range(0, len(lens), per):
        longest = max(lens[w : w + per])
        if longest:
            total += per * (longest + G - 1 + (longest + G - 1) % 2)
    return total


def _hand_walk(fp, rows, G, pairs=False):
    """Cells of one walk of ``rows`` query rows: its passes of ``16 G``
    rows, each over the pack's steps."""
    return -(-rows // (16 * G)) * 16 * G * _hand_steps(fp, G, pairs)


def _hand_counts(db, queries, with_ends):
    """Cells, bytes and launches (plain-version runs, on the CPU) of one
    `align_arrays` call, from the routing plan and the packs."""
    enc = [np.frombuffer(db.alphabet.encode(q), np.uint8) for q in queries]
    n = len(db)
    planes = 3 if with_ends else 1
    out = dict.fromkeys(
        ("cells.needed", "cells.walked", "copyback.bytes"), 0
    )
    launches = {}
    groups_by_walk = {}
    # K1 in sw score mode at 3/1: min(Q_pad, T_max) x 15 with targets of
    # under 60 residues stays within int16, so every K1 launch takes the
    # packed route (its floor of blocks lowered by the caller), a pair of
    # lanes a walk; K1 walks by route, counted in (query, target lane)
    # walks
    assert max(db.get_lengths()) < 60
    k1 = "ragged" if with_ends else "ragged_packed"
    k1_walks = "ragged.walks_wide" if with_ends else "ragged.walks_packed"

    def add(fp, qlens, walks, copied, pairs=False):
        out["cells.needed"] += sum(qlens) * fp.total_cells
        out["cells.walked"] += sum(_hand_walk(fp, r, G, pairs)
                                   for r, G in walks)
        out["copyback.bytes"] += copied * n * 4

    def k1_launch(fp, n_q):
        name = f"plain_calls.{k1}"
        launches[name] = launches.get(name, 0) + 1
        groups_by_walk[k1_walks] = (groups_by_walk.get(k1_walks, 0)
                                    + n_q * fp.lengths.size)

    kern = [q for q in enc if ragged.supports(len(q), "sw", with_ends, True)]
    for tier, lanes, groups, v2 in engine.plan_tier_launches(kern, True):
        for k in range(0, len(groups), engine._Q8_LAUNCH_GROUPS):
            gs = groups[k : k + engine._Q8_LAUNCH_GROUPS]
            fp = packing.pack_database_slice_flat(db, 0, n, lanes=lanes)
            # slot lengths: a partial group's empty slots are 0 and come
            # back all the same
            slots = len(gs) * q8.QB
            qlens = [len(kern[g[s]]) if s < len(g) else 0
                     for g in gs for s in range(q8.QB)]
            G = ragged.wave_group(tier)
            if with_ends:  # K2's int32 walk: each slot to its own length
                route, walk = "q8", "q8.groups_wide"
                walks = [(q, G) for q in qlens]
            else:  # sw score at 3/1: the packed walk, pairs of slots
                route, walk = "q8_packed", "q8.groups_packed"
                walks = [(max(qlens[s], qlens[s + 1]), G)
                         for s in range(0, slots, 2) for _ in range(2)]
            add(fp, qlens, walks, slots * planes)
            name = f"plain_calls.{route}"
            launches[name] = launches.get(name, 0) + 1
            groups_by_walk[walk] = groups_by_walk.get(walk, 0) + len(gs)
        if v2:
            fp = packing.pack_database_slice_flat(db, 0, n)
            qlens = [len(kern[i]) for i in v2]
            G = ragged.wave_group(tier)
            add(fp, qlens, [(q, G) for q in qlens], len(v2) * planes,
                pairs=not with_ends)
            k1_launch(fp, len(v2))
    for q in enc:
        Q = len(q)
        if ragged.supports(Q, "sw", with_ends, True):
            continue
        fp = packing.pack_database_slice_flat(db, 0, n)
        if ragged.supports_fine(Q, "sw", with_ends):
            walks = [(Q, ragged.wave_group(ragged.fine_qpad(Q)))]
            # the long path copies all three planes
            add(fp, [Q], walks, 3, pairs=not with_ends)
            k1_launch(fp, 1)
            continue
        qseg = ragged_long.QSEG
        walks = [
            (min(qseg, Q - r), ragged.wave_group(min(qseg, Q - r)))
            for r in range(0, Q, qseg)
        ]
        add(fp, [Q], walks, 3)
        name = "plain_calls.ragged_long"
        launches[name] = launches.get(name, 0) + -(-Q // qseg)
    out.update(launches)
    out.update(groups_by_walk)
    return out


@pytest.mark.parametrize("mode", ["score", "end"])
@pytest.mark.parametrize("batch", BATCHES)
def test_cells_and_bytes_equal_hand_counts(db, aligner, monkeypatch, batch,
                                           mode):
    queries = _batch(batch, monkeypatch, seed=3)
    # every K1 launch on a small database, as if it filled the card
    monkeypatch.setattr(engine, "_PACKED_MIN_BLOCKS", 1)
    _, _, counted = _profiled(
        lambda: aligner.align_arrays(queries, db, mode=mode)
    )
    want = _hand_counts(db, queries, mode != "score")
    assert {k: v for k, v in counted.items() if k in want} == want
    assert not any(
        k.startswith(("launches.", "plain_calls.", "q8.", "ragged."))
        and k not in want
        for k in counted
    )
    assert counted["cells.needed"] < counted["cells.walked"]
    # K1's packed route: its share of K1's walks, all of them in sw score
    # mode, none in end mode (the q8 batch launches no K1)
    packed = counted.get("ragged.walks_packed", 0)
    wide = counted.get("ragged.walks_wide", 0)
    assert (packed + wide > 0) is (batch != "q8")
    if packed + wide:
        assert packed / (packed + wide) == (1 if mode == "score" else 0)


@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("G", [2, 4, 8, 16])
def test_walk_steps_and_rows_by_hand(G, pairs):
    rng = np.random.default_rng(G)
    lengths = rng.integers(1, 90, (3, 1, 128)).astype(np.int32)
    lengths[1, 0, 40:] = 0  # padding lanes: whole warps of them
    lengths[2, 0, :: 32 // G] = 0  # a warp's first lane empty
    fp = packing.FlatPacked(
        n_targets=0, n_blocks=3, flat_targets=np.zeros((1, 128), np.uint8),
        lengths=lengths, indices=np.zeros((3, 128), np.int32),
        block_of_step=np.zeros(1, np.int32),
        chunk_of_step=np.zeros(1, np.int32),
        last_of_step=np.zeros(1, np.int32), inv_pos=np.zeros(0, np.int32),
    )
    assert ragged.walk_steps(lengths, G, pairs) == _hand_steps(fp, G, pairs)
    assert ragged.walk_steps(np.zeros((1, 1, 128), np.int32), G, pairs) == 0
    for rows in (0, 1, 16 * G - 1, 16 * G, 16 * G + 1, 100 * G):
        want = -(-rows // (16 * G)) * 16 * G
        assert ragged.walk_rows(rows, G) == want


def test_repeated_call_counts_a_profile_hit(db, aligner, monkeypatch):
    queries = _batch("q8", monkeypatch, seed=4) + _batch(
        "leftover", monkeypatch, seed=4
    )
    _, _, first = _profiled(lambda: aligner.align_arrays(queries, db))
    _, _, again = _profiled(lambda: aligner.align_arrays(queries, db))
    assert first.get("profile.hits", 0) == 0 and first["profile.misses"] == 3
    assert again.get("profile.misses", 0) == 0 and again["profile.hits"] == 3
    for key in ("cells.needed", "cells.walked", "copyback.bytes"):
        assert first[key] == again[key]


def test_threads_count_what_one_thread_counts(db):
    query = _seq(np.random.default_rng(5), 70)
    n = len(db)
    bounds = list(_chunk_bounds(n, 2))
    assert len(bounds) == 2

    def search(threads):
        return list(pt.align(query, db, threads=threads, device="cpu"))

    _, _, one = _profiled(lambda: search(1))
    _, _, two = _profiled(lambda: search(2))
    aligner = pt.Aligner(device="cpu")
    _, _, chunks = _profiled(
        lambda: [aligner.align(query, db, start=a, end=b) for a, b in bounds]
    )
    for key in ("cells.needed", "copyback.bytes"):
        assert two[key] == one[key]

    def kernel_counts(c):
        return {k: v for k, v in c.items() if not k.startswith("profile.")}

    # the workers' chunks are packed apart, so their walks are those of
    # the chunks searched one after another
    assert kernel_counts(two) == kernel_counts(chunks)
    assert two["plain_calls.ragged"] == 2


def test_trace_writes_the_spans_and_counters(db, aligner, tmp_path):
    queries = _batch("leftover", None, seed=6)
    logdir = tmp_path / "trace"
    profiling.reset_counters()
    profiling.count("cells.needed", 1)  # not recording: nothing counted
    with profiling.trace(str(logdir)):
        aligner.align_batch(queries, db)
    written = json.loads((logdir / "counters.json").read_text())
    launched = {
        k: written.pop(k) for k in list(written)
        if k.startswith(("launches.", "plain_calls."))
    }
    assert written == profiling.counters()
    assert written["cells.needed"] > 0
    assert launched == {"plain_calls.ragged": 2}
    names = {
        e.get("name")
        for e in json.loads((logdir / "trace.json").read_text())["traceEvents"]
    }
    assert STAGES | {"pyopal.align_batch", "pyopal.results"} <= names
