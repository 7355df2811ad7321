"""The check fails a run whose timed path is broken underneath: the
harness runs the fixture cell on the CPU with the program patched, and
``correct`` comes out false for each fault a search cell can have.  The
control, the reference in 8-bit saturating arithmetic in the program's
place, fails too."""

import numpy as np
import pytest

from benchmark import check, generate, reference
from benchmark.tests import fixture_cell


def long_database():
    # targets long enough for homolog scores past 255 under BLOSUM50 3/1
    return fixture_cell.tiny_database(count=60, median=200, clip=(60, 400))


def stale(monkeypatch):
    """A call that returns the previous call's answers (a cache keyed on
    the wrong thing)."""
    import pyopal_tpu_torch as pt

    real = pt.Aligner.align_arrays
    memo = {}

    def fake(self, queries, db, **kw):
        out = memo.get("last") or real(self, queries, db, **kw)
        memo["last"] = real(self, queries, db, **kw)
        return out

    monkeypatch.setattr(pt.Aligner, "align_arrays", fake)


def half(monkeypatch):
    """Half of each call's queries left out: their rows never computed."""
    from pyopal_tpu_torch.ops import engine

    real = engine.search_scores_batch

    def fake(database, start, end, queries_enc, *a, **kw):
        keep = max(1, len(queries_enc) // 2)
        s, qe, te = real(database, start, end, queries_enc[:keep], *a, **kw)
        pad = np.zeros((len(queries_enc) - keep, s.shape[1]), s.dtype)
        return (np.concatenate([s, pad]), np.concatenate([qe, pad]),
                np.concatenate([te, pad]))

    monkeypatch.setattr(engine, "search_scores_batch", fake)


def altered(monkeypatch):
    """One answer altered where the kernels produce it."""
    from pyopal_tpu_torch.ops import q8, ragged

    for mod, name in ((q8, "search_flat_q8"), (ragged, "search_flat")):
        real = getattr(mod, name)

        def fake(*a, _real=real, **kw):
            s, qe, te = _real(*a, **kw)
            s = s.clone()
            s.view(-1)[0] += 1
            return s, qe, te

        monkeypatch.setattr(mod, name, fake)


@pytest.mark.parametrize("fault", [stale, half, altered])
def test_fault_fails_the_check(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    out = fixture_cell.run(tmp_path, monkeypatch, seconds=0.6,
                           database=long_database())
    assert out["correct"] is False
    assert out["check"]["score_mismatches"]["value"] > 0


def test_query_cell_with_half_the_targets_fails(tmp_path, monkeypatch):
    import pyopal_tpu_torch as pt

    real = pt.Aligner.align

    def fake(self, query, db, **kw):
        res = real(self, query, db, **kw)
        return res[: len(res) // 2]

    monkeypatch.setattr(pt.Aligner, "align", fake)
    out = fixture_cell.run(
        tmp_path, monkeypatch, api="align", per_call=1, lengths=(40, 70),
        one_query=True, check={"calls": 1, "targets": "all"},
    )
    assert out["correct"] is False
    assert out["check"]["index_mismatches"]["value"] > 0


@pytest.mark.parametrize("config,targets", [
    ("sprot12071-blosum50", "all"),
    ("swissprot-blosum62", {"sample": 16, "include_sources": True}),
])
def test_control_fails_the_check(config, targets):
    import json

    cfg = json.loads((fixture_cell.BENCH / "configs" / f"{config}.json").read_text())
    cfg["database"] = long_database()
    scoring = cfg["scoring"]

    class Data:
        lengths = generate.database_lengths(cfg["database"])
        offsets = generate.offsets_of(lengths)
        codes = generate.database_codes(int(lengths.sum()), 21, "cpu")

    traffic = {"queries_per_call": 2, "lengths": {"values": [150]},
               "residues": {"from": "database_window", "substitution": 0.3}}
    stream = generate.QueryStream(traffic, Data.lengths, Data.codes, 21, 0)
    kept = [(stream.call(k), None) for k in range(2)]

    def control(call, t):
        return reference.sw_scores(
            call.codes, Data.codes, Data.offsets, Data.lengths, t,
            scoring["table"], scoring["gap_open"], scoring["gap_extend"],
            device="cpu", cap=255,
        )

    verdict = check.compare(kept, Data, scoring, targets, 21, "cpu", 0,
                            program=control)
    assert verdict.correct is False
    assert verdict.numbers["score_mismatches"] > 0
    sound = check.compare(
        kept, Data, scoring, targets, 21, "cpu", 0,
        program=lambda call, t: reference.sw_scores(
            call.codes, Data.codes, Data.offsets, Data.lengths, t,
            scoring["table"], scoring["gap_open"], scoring["gap_extend"],
            device="cpu"),
    )
    assert sound.correct is True


def test_a_call_that_raises_fails_the_check(tmp_path, monkeypatch):
    import pyopal_tpu_torch as pt

    real = pt.Aligner.align_arrays
    seen = []

    def fake(self, queries, db, **kw):
        seen.append(1)
        if len(seen) > 1:  # the warm-up call passes, the window's raise
            raise RuntimeError("planted")
        return real(self, queries, db, **kw)

    monkeypatch.setattr(pt.Aligner, "align_arrays", fake)
    out = fixture_cell.run(tmp_path, monkeypatch, seconds=0.2)
    assert out["correct"] is False
    assert out["failed"] == out["attempted"] >= 1
    assert out["check"]["failed_calls"]["value"] == out["failed"]
