"""The plain reference against a brute-force scorer of its own, and the
configurations' tables against the program's matrices."""

import json

import numpy as np
import pytest

from benchmark import generate, reference
from benchmark.tests import fixture_cell

GAPS = {"sprot12071-blosum50": (3, 1), "swissprot-blosum62": (12, 2)}


def table(name):
    cfg = json.loads((fixture_cell.BENCH / "configs" / f"{name}.json").read_text())
    return np.array(cfg["scoring"]["table"]), cfg["scoring"]


@pytest.mark.parametrize("name", sorted(GAPS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_matches_brute_force(name, seed):
    S, scoring = table(name)
    go, ge = GAPS[name]
    assert (scoring["gap_open"], scoring["gap_extend"]) == (go, ge)
    rng = np.random.default_rng(seed)
    lens = np.array([1, 2, 9, 17, 33, 24, 5])
    codes = rng.integers(0, 20, lens.sum()).astype(np.uint8)
    offsets = generate.offsets_of(lens)
    # a query that shares a stretch with target 4 scores high
    queries = [rng.integers(0, 20, n).astype(np.uint8) for n in (1, 6, 15)]
    queries.append(codes[offsets[4] + 3 : offsets[4] + 28].copy())
    got = reference.sw_scores(
        queries, codes, offsets, lens, np.arange(len(lens)), S, go, ge,
        device="cpu", block_cells=40,
    )
    want = np.array([
        [reference.sw_score_brute(q, codes[o : o + n], S, go, ge)
         for o, n in zip(offsets, lens)]
        for q in queries
    ])
    assert np.array_equal(got, want)
    assert want.max() > 60


@pytest.mark.parametrize("go,ge", [(3, 1), (12, 2), (4, 4), (0, 0)])
def test_reference_gap_settings(go, ge):
    S, _ = table("swissprot-blosum62")
    rng = np.random.default_rng(go * 10 + ge)
    lens = np.array([7, 30, 12])
    codes = rng.integers(0, 20, lens.sum()).astype(np.uint8)
    offsets = generate.offsets_of(lens)
    q = [rng.integers(0, 20, 20).astype(np.uint8)]
    got = reference.sw_scores(q, codes, offsets, lens, [2, 0], S, go, ge, device="cpu")
    want = [reference.sw_score_brute(q[0], codes[offsets[t] : offsets[t] + lens[t]], S, go, ge) for t in (2, 0)]
    assert got[0].tolist() == want


def test_cap_saturates_like_a_narrow_pass():
    S, _ = table("sprot12071-blosum50")
    rng = np.random.default_rng(4)
    lens = np.array([80, 120, 60])
    codes = rng.integers(0, 20, lens.sum()).astype(np.uint8)
    offsets = generate.offsets_of(lens)
    q = [codes[40:160].copy(), rng.integers(0, 20, 30).astype(np.uint8)]
    exact = reference.sw_scores(q, codes, offsets, lens, range(3), S, 3, 1, device="cpu")
    low = reference.sw_scores(q, codes, offsets, lens, range(3), S, 3, 1, device="cpu", cap=255)
    assert exact.max() > 255
    assert np.array_equal(low, np.minimum(exact, 255))


def test_reference_refuses_open_below_extend():
    with pytest.raises(ValueError):
        reference.sw_scores([np.zeros(3, np.uint8)], np.zeros(3, np.uint8), [0], [3], [0], np.eye(20), 1, 2, device="cpu")


@pytest.mark.parametrize("name", sorted(GAPS))
def test_tables_are_the_programs_matrices(name):
    import pyopal_tpu_torch as pt

    S, scoring = table(name)
    aligner = pt.Aligner(scoring["matrix"], device="cpu")
    letters = scoring["letters"]
    assert aligner.alphabet.letters[:20] == letters == generate.LETTERS.decode()
    assert np.array_equal(aligner.scoring_matrix.int_data()[:20, :20], S)
