"""A cell of another alphabet, algorithm and mode, defined only by data
files: a 4-letter configuration with a match/mismatch table and no named
matrix, run end to end through the harness on the CPU.  The check holds
its scores and end positions to the plain reference, counts what a
broken program returns, and set-up refuses what it cannot judge."""

import sys

import numpy as np
import pytest

from benchmark import generate, harness, reference
from benchmark.tests import fixture_cell

DNA = fixture_cell.DNA_SCORING


def dna_run(tmp, monkeypatch, algorithm="hw", mode="end", **kw):
    scoring = dict(DNA, algorithm=algorithm)
    return fixture_cell.run(
        tmp, monkeypatch, scoring=scoring,
        options={"mode": mode, "algorithm": algorithm}, **kw,
    )


@pytest.mark.parametrize("algorithm,mode", [
    ("hw", "end"), ("hw", "score"), ("nw", "end"), ("ov", "end"), ("sw", "end"),
])
def test_dna_cell_is_correct(tmp_path, monkeypatch, algorithm, mode):
    out = dna_run(tmp_path, monkeypatch, algorithm, mode)
    assert out["correct"] is True, out["check"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    numbers = {k: v["value"] for k, v in out["check"].items()}
    if mode == "end":
        assert numbers.pop("end_mismatches") == 0
        assert out["check"]["end_mismatches"]["limit"] == 0
    assert numbers == {"score_mismatches": 0, "index_mismatches": 0,
                       "failed_calls": 0}


def shifted_target_ends(out, self, queries, db):
    out["target_ends"] = out["target_ends"] + 1


def sw_reference_scores(out, self, queries, db):
    seqs = [db.get_encoded(i) for i in range(len(db))]
    lens = np.array([len(x) for x in seqs])
    qs = [np.frombuffer(db.alphabet.encode(q), np.uint8) for q in queries]
    out["scores"] = reference.sw_scores(
        qs, np.concatenate(seqs), generate.offsets_of(lens), lens,
        np.arange(len(seqs)), DNA["table"], DNA["gap_open"],
        DNA["gap_extend"], device="cpu",
    )


@pytest.mark.parametrize("fault,counted", [
    (shifted_target_ends, "end_mismatches"),
    (sw_reference_scores, "score_mismatches"),
])
def test_dna_cell_counts_a_broken_program(tmp_path, monkeypatch, fault, counted):
    import pyopal_tpu_torch as pt

    real = pt.Aligner.align_arrays

    def fake(self, queries, db, **kw):
        out = real(self, queries, db, **kw)
        fault(out, self, queries, db)
        return out

    monkeypatch.setattr(pt.Aligner, "align_arrays", fake)
    out = dna_run(tmp_path, monkeypatch)
    assert out["correct"] is False
    assert out["check"][counted]["value"] > 0


@pytest.mark.parametrize("options,named", [
    ({"mode": "end", "algorithm": "sw"}, ["'sw'", "'hw'"]),
    ({"mode": "full", "algorithm": "hw"}, ["'full'", "'hw'"]),
])
def test_setup_refuses_a_cell_it_cannot_judge(tmp_path, monkeypatch, options, named):
    with pytest.raises(harness.Failure) as err:
        fixture_cell.run(tmp_path, monkeypatch, scoring=DNA, options=options)
    assert err.value.code == 2
    assert all(word in str(err.value) for word in named), str(err.value)


def test_control_refuses_other_cells(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "path", list(sys.path))  # control.py sets [0]
    from benchmark import control

    root, data, name = fixture_cell.make_cell(
        tmp_path, scoring=DNA, options={"mode": "end", "algorithm": "hw"}
    )
    spec = harness.Spec(root, name, data)
    with pytest.raises(harness.Failure, match="sw score-mode cells only"):
        control.control_reading(spec, 1, "cpu", 255)


def test_dna_residues_are_the_configurations_letters(tmp_path):
    root, data, name = fixture_cell.make_cell(tmp_path, scoring=DNA)
    spec = harness.Spec(root, name, data)
    d = harness.Data(spec.config, 5, "cpu")
    assert d.codes.max() == 3
    call = d.queries(spec.traffic, 5, generate.STREAM_WINDOW).call(0)
    text = b"".join(generate.ascii_sequences(d.codes, d.lengths, d.letters))
    assert set(text) == set(b"ACGT")
    assert set(b"".join(call.letters)) == set(b"ACGT")
    same = np.mean([
        (d.codes[start : start + q.shape[0]] == q).mean()
        for start, q in zip(call.starts, call.codes)
    ])
    assert 0.7 < same < 0.85  # 30% redrawn, a quarter of them alike
