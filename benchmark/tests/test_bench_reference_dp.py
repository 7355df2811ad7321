"""The plain reference of every algorithm against a scalar brute force of
its own, scores and end positions, ties included; it loads nothing of
the program."""

import json
import subprocess
import sys

import numpy as np
import pytest

from benchmark import generate, reference_dp
from benchmark.tests import fixture_cell

NINF = -(1 << 40)


def brute(query, target, S, go, ge, algorithm):
    """One pair, cell by cell in plain Python: ``(score, q_end, t_end)``."""
    Q, T = len(query), len(target)
    H = [[0] * (T + 1) for _ in range(Q + 1)]
    E = [[NINF] * (T + 1) for _ in range(Q + 1)]
    Fm = [[NINF] * (T + 1) for _ in range(Q + 1)]
    if algorithm == "nw":
        for j in range(1, T + 1):
            H[0][j] = -(go + (j - 1) * ge)
    if algorithm in ("nw", "hw"):
        for i in range(1, Q + 1):
            H[i][0] = -(go + (i - 1) * ge)
    for i in range(1, Q + 1):
        for j in range(1, T + 1):
            E[i][j] = max(E[i][j - 1] - ge, H[i][j - 1] - go)
            Fm[i][j] = max(Fm[i - 1][j] - ge, H[i - 1][j] - go)
            h = max(H[i - 1][j - 1] + int(S[query[i - 1]][target[j - 1]]),
                    E[i][j], Fm[i][j])
            H[i][j] = max(h, 0) if algorithm == "sw" else h
    if algorithm == "nw":
        return H[Q][T], Q - 1, T - 1
    if algorithm == "sw":
        best, bi, bj = 0, 0, 0
        for j in range(1, T + 1):  # sweep order: target first
            for i in range(1, Q + 1):
                if H[i][j] > best:
                    best, bi, bj = H[i][j], i, j
        return (best, bi - 1, bj - 1) if best > 0 else (0, -1, -1)
    best, bi, bj = H[Q][0], Q, 0
    for j in range(1, T + 1):
        if H[Q][j] > best:
            best, bj = H[Q][j], j
    if algorithm == "ov":
        for i in range(1, Q + 1):
            if H[i][T] > best:
                best, bi, bj = H[i][T], i, T
    return best, bi - 1, bj - 1


# (letters, gap_open, gap_extend, block_cells): a 2-letter alphabet for
# ties; go == ge; ge == 0; blocks that split the targets
SETTINGS = {
    "dna": (4, 5, 2, 1 << 27),
    "two_letters": (2, 3, 1, 1 << 27),
    "open_is_extend": (4, 3, 3, 1 << 27),
    "no_extend": (20, 4, 0, 1 << 27),
    "blocks": (4, 5, 2, 150),
}


def case(letters, seed):
    rng = np.random.default_rng(seed)
    if letters == 20:
        cfg = json.loads(
            (fixture_cell.BENCH / "configs" / "sprot12071-blosum50.json").read_text()
        )
        S = np.array(cfg["scoring"]["table"])
    else:
        S = np.where(np.eye(letters, dtype=bool), 2, -3)
    lens = np.array([1, 2, 9, 17, 33, 24, 5, 12])
    codes = rng.integers(0, letters, lens.sum()).astype(np.uint8)
    offsets = generate.offsets_of(lens)
    # length 1, short random queries, and one sharing a stretch with target 4
    queries = [rng.integers(0, letters, n).astype(np.uint8) for n in (1, 6, 15)]
    queries.append(codes[offsets[4] + 3 : offsets[4] + 25].copy())
    return S, lens, codes, offsets, queries


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("algorithm", reference_dp.ALGORITHMS)
@pytest.mark.parametrize("ends", [False, True], ids=["score", "end"])
@pytest.mark.parametrize("seed", [0, 1])
def test_reference_dp_matches_brute_force(setting, algorithm, ends, seed):
    letters, go, ge, block_cells = SETTINGS[setting]
    S, lens, codes, offsets, queries = case(letters, seed)
    targets = np.array([6, 0, 3, 1, 4, 7, 2, 5])
    got = reference_dp.search(
        queries, codes, offsets, lens, targets, S, go, ge,
        algorithm=algorithm, ends=ends, device="cpu", block_cells=block_cells,
    )
    want = np.array([
        [brute(q, codes[offsets[t] : offsets[t] + lens[t]], S, go, ge, algorithm)
         for t in targets]
        for q in queries
    ]).transpose(2, 0, 1)
    assert got.dtype == np.int32
    assert np.array_equal(got, want if ends else want[:1])


def test_reference_dp_sw_scores_equal_sw_reference():
    from benchmark import reference

    S, lens, codes, offsets, queries = case(20, 3)
    t = np.arange(len(lens))
    got = reference_dp.search(queries, codes, offsets, lens, t, S, 3, 1,
                              algorithm="sw", ends=False, device="cpu")
    want = reference.sw_scores(queries, codes, offsets, lens, t, S, 3, 1,
                               device="cpu")
    assert np.array_equal(got[0], want)


def test_reference_dp_refuses_what_it_cannot_read():
    args = ([np.zeros(3, np.uint8)], np.zeros(3, np.uint8), [0], [3], [0],
            np.eye(4, dtype=int))
    with pytest.raises(ValueError):
        reference_dp.search(*args, 1, 2, algorithm="hw", ends=True, device="cpu")
    with pytest.raises(ValueError):
        reference_dp.search(*args, 3, 1, algorithm="xx", ends=True, device="cpu")
    with pytest.raises(ValueError):
        reference_dp.search([np.zeros(0, np.uint8)], *args[1:], 3, 1,
                            algorithm="nw", ends=False, device="cpu")


RUN_REFERENCE_DP = """
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np
from benchmark import reference_dp
codes = np.arange(14, dtype=np.uint8) % 4
print(reference_dp.search([codes[:4]], codes, [0, 5], [5, 9], [0, 1],
                          np.eye(4, dtype=int), 3, 1, algorithm="hw",
                          ends=True, device="cpu").tolist(), file=sys.stderr)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_reference_dp_loads_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, "-c", RUN_REFERENCE_DP.format(repo=str(fixture_cell.REPO))],
        capture_output=True, text=True, timeout=600, cwd="/",
    )
    assert out.returncode == 0, out.stderr[-3000:]
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in mods
    assert not any(m.startswith("pyopal_tpu") or m in ("jax", "jaxlib", "flax")
                   for m in mods)
