"""The port's search path as a whole, on the CPU, against `pyopal_tpu`.

`pyopal_tpu_torch` with ``device="cpu"`` runs the same dispatch as on
the card with the kernels' plain versions (or the sweep, where the
kernels do not take a call); every result must equal the reference
package's exactly.
"""

import itertools
import pickle
import random

import numpy as np
import pytest

import pyopal_tpu as po
import pyopal_tpu_torch as pt
from pyopal_tpu.ops import engine as ref_engine
from pyopal_tpu_torch import convert
from pyopal_tpu_torch.ops import engine, naive, q8, ragged, ragged_long, sweep
import _torch_cpu  # noqa: F401  (torch threads: a worker's share)


def _case(seed):
    """The seeded random config of ``tests/test_fuzz.py::_case``, as
    numpy state (letters, matrix) that both packages load."""
    rng = random.Random(seed)
    nrg = np.random.default_rng(seed)
    asize = rng.choice([2, 4, 20, 24, 27])
    letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZ*"[:asize]
    hi = rng.choice([5, 17, 250])
    m = nrg.integers(-hi, hi + 1, (asize, asize))
    m = ((m + m.T) // 2).astype(np.float32)
    go = rng.choice([0, 1, 3, 11])
    ge = rng.choice([0, 1, 2, 7])
    algo = rng.choice(["nw", "hw", "ov", "sw"])
    mode = rng.choice(["score", "end"])
    n = rng.randint(1, 40)
    lens = [rng.choice([0, 1, 2, 17, 63, 64, 65, 130]) for _ in range(n)]
    targets = [
        "".join(rng.choices(letters[: max(asize - 1, 1)], k=k))
        for k in lens
    ]
    qlen = rng.choice([1, 5, 33, 64, 100])
    query = "".join(rng.choices(letters[: max(asize - 1, 1)], k=qlen))
    return letters, m, go, ge, algo, mode, targets, query


def _both(letters, m, go, ge, targets):
    ref_matrix = po.ScoringMatrix(m, letters)
    ref_db = po.Database(targets, alphabet=letters)
    matrix = convert.scoring_matrix_from_numpy(letters, m)
    db = convert.database_from_numpy(
        letters, [ref_db.get_encoded(i) for i in range(len(ref_db))]
    )
    return (
        po.Aligner(ref_matrix, gap_open=go, gap_extend=ge),
        ref_db,
        pt.Aligner(matrix, gap_open=go, gap_extend=ge, device="cpu"),
        db,
    )


def _tuples(results):
    return [
        (r.target_index, r.score, getattr(r, "query_end", None),
         getattr(r, "target_end", None))
        for r in results
    ]


@pytest.mark.parametrize("seed", range(32))
def test_fuzz_config_matches_reference(seed):
    letters, m, go, ge, algo, mode, targets, query = _case(seed)
    ref_al, ref_db, al, db = _both(letters, m, go, ge, targets)
    rng = random.Random(seed ^ 0xBEEF)
    others = [
        "".join(rng.choices(letters[: max(len(letters) - 1, 1)], k=k))
        for k in (0, 7, 40)
    ]
    queries = [query] + others
    kw = dict(mode=mode, algorithm=algo)

    assert _tuples(al.align(query, db, **kw)) == _tuples(
        ref_al.align(query, ref_db, **kw)
    )
    got = al.align_batch(queries, db, **kw)
    ref = ref_al.align_batch(queries, ref_db, **kw)
    assert [_tuples(x) for x in got] == [_tuples(x) for x in ref]
    got = al.align_arrays(queries, db, start=1, **kw)
    ref = ref_al.align_arrays(queries, ref_db, start=1, **kw)
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_batch_routes_through_both_kernels(monkeypatch):
    """11 same-tier queries (one full q8 group + 3 leftovers) and one
    query of another tier, against the reference's Pallas dispatch run
    with interpreted kernels: the port must take the q8 and ragged
    plain versions and never the sweep."""
    monkeypatch.setattr(ref_engine, "_INTERPRET", True)
    rng = np.random.default_rng(5)
    letters = po.Alphabet().letters
    targets = [
        "".join(rng.choice(list(letters[:20]), int(n)))
        for n in [0, 1, 63, 64, 65, 129] + list(rng.integers(1, 150, 30))
    ]
    queries = [
        "".join(rng.choice(list(letters[:20]), int(n)))
        for n in [70, 90, 100, 128, 77, 65, 99, 120, 110, 81, 66, 30]
    ]
    ref_al = po.Aligner()
    ref_db = po.Database(targets)
    al = pt.Aligner(device="cpu")
    db = pt.Database(targets)
    counts = (q8.plain_calls["q8"], ragged.plain_calls["ragged"],
              sweep.launches)
    got = al.align_arrays(queries, db, mode="end")
    after = (q8.plain_calls["q8"], ragged.plain_calls["ragged"],
             sweep.launches)
    ref = ref_al.align_arrays(queries, ref_db, mode="end")
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert after[0] - counts[0] == 1  # one q8 launch: the full group
    assert after[1] - counts[1] == 2  # ragged: tier-128 leftovers, tier 64
    assert after[2] == counts[2]  # nothing took the sweep


@pytest.mark.parametrize("algo, with_ends", [("sw", False), ("ov", True)])
def test_32_column_matrix_routes_as_reference(monkeypatch, algo, with_ends):
    """A 32-column matrix leaves the pad symbol no padding column, so
    both packages drop ``safe_pad``: no q8 group and no fine tier; the
    tier-64 cohort takes K4 and, with the tier ceiling of K4 lowered to
    64 in both packages, a 300-residue query takes K5 in score mode and
    K3 (10 segments of 32 rows) in end mode.  Against the reference's
    dispatch with interpreted kernels, all three planes, an empty query
    included."""
    from pyopal_tpu.ops import pallas_ragged as pr
    from pyopal_tpu.ops import pallas_ragged_long as prl

    monkeypatch.setattr(ref_engine, "_INTERPRET", True)
    for mod in (pr, ragged):
        monkeypatch.setattr(mod, "RAGGED_MAX_QPAD", 64)
    for mod in (prl, ragged_long):
        monkeypatch.setattr(mod, "QSEG", 32)
    rng = np.random.default_rng(32)
    m = rng.integers(-5, 6, (32, 32))
    matrix = ((m + m.T) // 2).astype(np.int32)
    letters = po.Alphabet().letters
    targets = [
        "".join(rng.choice(list(letters[:23]), int(n)))
        for n in [0, 1, 63, 64, 65, 129] + list(rng.integers(1, 150, 20))
    ]
    queries = [rng.integers(0, 24, n).astype(np.uint8)
               for n in (40, 17, 64, 9, 0, 300)]
    db, ref_db = pt.Database(targets), po.Database(targets)
    queries[5][100:130] = db.get_encoded(5)[50:80]
    n = len(targets)
    counts = lambda: (q8.plain_calls["q8"],  # noqa: E731
                      *ragged.plain_calls.values(),
                      ragged_long.plain_calls, sweep.launches)
    before = counts()
    got = engine.search_scores_batch(db, 0, n, queries, matrix, 3, 1, algo,
                                     with_ends, device="cpu")
    after = counts()
    ref = ref_engine.search_scores_batch(ref_db, 0, n, queries, matrix, 3,
                                         1, algo, with_ends)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    # q8, K1, K4, K5, K1's packed route, K3 (segments), sweep
    want = [0, 0, 1, 0, 0, 10, 0] if with_ends else [0, 0, 1, 1, 0, 0, 0]
    assert [a - b for a, b in zip(after, before)] == want


def test_sweep_takes_what_the_kernels_do_not():
    """A matrix entry beyond +-256 fails the kernel predicate: the call
    goes to the sweep, and still equals the oracle."""
    letters = "ACGT"
    m = np.full((4, 4), -300, np.float32)
    np.fill_diagonal(m, 400)
    al = pt.Aligner(
        convert.scoring_matrix_from_numpy(letters, m), device="cpu"
    )
    targets = ["ACGTTGCA", "", "A", "GGGG"]
    db = pt.Database(targets, alphabet=letters)
    before = (sweep.launches, ragged.plain_calls["ragged"])
    res = al.align("ACGTA", db, mode="end", algorithm="ov")
    assert sweep.launches == before[0] + 1
    assert ragged.plain_calls["ragged"] == before[1]
    S = m.astype(np.int32)
    enc = lambda s: np.frombuffer(db.alphabet.encode(s), np.uint8)  # noqa
    for r, t in zip(res, targets):
        assert (r.score, r.query_end, r.target_end) == naive.score_end(
            enc("ACGTA"), enc(t), S, 3, 1, "ov"
        )


def test_long_query_takes_the_sweep():
    """A query beyond 4096 residues no longer takes the sweep (the name
    is kept from when it did): it takes K1 alone at its fine tier, 4608
    rows, and the short query of the same batch its own K1 launch."""
    rng = np.random.default_rng(4)
    al = pt.Aligner(device="cpu")
    plain = al.alphabet.letters[:20]
    query = "".join(rng.choice(list(plain), 4100))
    targets = ["".join(rng.choice(list(plain), n)) for n in (0, 1, 9, 30)]
    db = pt.Database(targets)
    assert ragged.fine_qpad(4100) == 4608
    assert ragged.supports_fine(4100, "sw", True)
    before = (sweep.launches, ragged.plain_calls["ragged"],
              ragged_long.plain_calls)
    res = al.align_batch([query, query[:10]], db, mode="end")
    assert sweep.launches == before[0]
    assert ragged.plain_calls["ragged"] - before[1] == 2
    assert ragged_long.plain_calls == before[2]
    S = al.scoring_matrix.int_data()
    enc = lambda s: np.frombuffer(db.alphabet.encode(s), np.uint8)  # noqa
    for qq, hits in zip([query, query[:10]], res):
        for r, t in zip(hits, targets):
            want = naive.score_end(enc(qq), enc(t), S, 3, 1, "sw")
            assert (r.score, r.query_end, r.target_end) == want


@pytest.mark.parametrize("algo", ["nw", "hw", "ov", "sw"])
def test_sweep_search_block_matches_reference(algo):
    """The sweep's single-query entry against the reference XLA engine
    (`pyopal_tpu.ops.xla.search_block`) on one padded block."""
    import jax.numpy as jnp
    import torch

    from pyopal_tpu.ops import xla

    rng = np.random.default_rng(17)
    S = po.ScoringMatrix.from_name("BLOSUM50").int_data()
    q = rng.integers(0, 24, 45).astype(np.uint8)
    lens = np.array([0, 1, 2, 17, 63, 64, 65, 90], np.int32)
    targets = rng.integers(0, 24, (96, lens.shape[0])).astype(np.int32)
    for go, ge in ((3, 1), (1, 3)):
        ref = xla.search_block(
            jnp.asarray(xla.make_profile_t(q, S)), jnp.asarray(targets),
            jnp.asarray(lens), go, ge, algo,
        )
        got = sweep.search_block(
            torch.from_numpy(sweep.make_profile_t(q, S)),
            torch.from_numpy(targets), torch.from_numpy(lens), go, ge, algo,
        )
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_plan_tier_launches_matches_reference():
    rng = np.random.default_rng(9)
    lens = [1, 8, 63, 64, 65, 129, 256, 257, 600, 3000] * 3 + [70] * 13
    queries = [rng.integers(0, 20, n).astype(np.uint8) for n in lens]
    for safe_pad in (True, False):
        assert engine.plan_tier_launches(
            queries, safe_pad
        ) == ref_engine.plan_tier_launches(queries, safe_pad)


def test_golden_values():
    al = pt.Aligner(device="cpu")
    db = pt.Database(["AACCGCTG"])
    (nw,) = al.align("ACCTCG", db, mode="end", algorithm="nw")
    assert (nw.score, nw.query_end, nw.target_end) == (44, 5, 7)
    (sw,) = al.align("ACCTCG", db, mode="score", algorithm="sw")
    assert sw.score == 47
    targets = ["AACCGCTG", "ATGCGCT", "TTATTACG"]
    hits = pt.align("ACCTG", targets, gap_open=2, ordered=True, device="cpu")
    assert [r.score for r in hits] == [41, 31, 23]
    hits = pt.align(
        "ACCTG", targets, gap_open=2, ordered=True, threads=2, device="cpu"
    )
    assert sorted(r.score for r in hits) == [23, 31, 41]


def _full(results):
    return [
        (r.target_index, r.score, r.query_end, r.target_end, r.query_start,
         r.target_start, r.query_length, r.target_length, r.alignment,
         r.cigar())
        for r in results
    ]


@pytest.mark.parametrize("seed", range(2))
def test_full_mode_and_top_k_match_reference(seed):
    """Full mode and top-k through every entry point, on the seeded
    configs of ``tests/test_fuzz.py``: starts, ends, CIGARs and result
    order equal the reference's."""
    letters, m, go, ge, algo, _, targets, query = _case(seed)
    ref_al, ref_db, al, db = _both(letters, m, go, ge, targets)
    rng = random.Random(seed ^ 0xF011)
    others = [
        "".join(rng.choices(letters[: max(len(letters) - 1, 1)], k=k))
        for k in (0, 23)
    ]
    queries = [query] + others
    kw = dict(mode="full", algorithm=algo)

    assert _full(al.align(query, db, **kw)) == _full(
        ref_al.align(query, ref_db, **kw))
    want = [_full(x) for x in ref_al.align_batch(queries, ref_db, **kw)]
    assert [_full(x) for x in al.align_batch(queries, db, **kw)] == want
    assert [_full(x) for x in al.align_many(queries, db, batch_size=2,
                                            **kw)] == want
    futures = [al.align_async(q, db, **kw) for q in queries]
    assert [_full(f.result()) for f in futures] == want
    got = al.align_arrays(queries, db, start=1, **kw)
    ref = ref_al.align_arrays(queries, ref_db, start=1, **kw)
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    for k in (0, 3, 100):
        assert _full(al.align_top_k(query, db, k=k, algorithm=algo)) == _full(
            ref_al.align_top_k(query, ref_db, k=k, algorithm=algo))
    top = al.align_top_k(query, db, k=4, algorithm=algo, start=2, end=30)
    assert _full(top) == _full(ref_al.align_top_k(
        query, ref_db, k=4, algorithm=algo, start=2, end=30))
    got = pt.align(query, db, al.scoring_matrix, gap_open=go, gap_extend=ge,
                   ordered=True, threads=2, device="cpu", **kw)
    ref = po.align(query, ref_db, ref_al.scoring_matrix, gap_open=go,
                   gap_extend=ge, ordered=True, threads=2, **kw)
    assert _full(got) == _full(ref)


def test_full_mode_golden_values():
    al = pt.Aligner(device="cpu")
    db = pt.Database(["AACCGCTG"])
    (nw,) = al.align("ACCTCG", db, mode="full", algorithm="nw")
    assert (nw.score, nw.query_end, nw.target_end) == (44, 5, 7)
    assert (nw.query_start, nw.target_start) == (0, 0)
    assert nw.cigar() == "1D5M1D1M"
    (sw,) = al.align("ACCTCG", db, mode="full", algorithm="sw")
    assert (sw.score, sw.target_start) == (47, 1)
    (top,) = al.align_top_k("ACCTCG", db, k=5, algorithm="nw")
    assert _full([top]) == _full([nw])


def test_full_mode_empty_slice_and_errors_match_reference():
    ref_al, ref_db = po.Aligner(), po.Database(["MKVLAT", "MKV", "AAAA"])
    al, db = pt.Aligner(device="cpu"), pt.Database(["MKVLAT", "MKV", "AAAA"])
    got = al.align_arrays(["MKV", "LAT"], db, mode="full", start=5)
    ref = ref_al.align_arrays(["MKV", "LAT"], ref_db, mode="full", start=5)
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key].shape == ref[key].shape == (2, 0), key
        assert got[key].dtype == ref[key].dtype, key
    assert al.align_top_k("MKV", db, start=5) == []
    other = pt.Database(["ACGT"], alphabet=pt.Alphabet("ACGT"))
    ref_other = po.Database(["ACGT"], alphabet=po.Alphabet("ACGT"))
    for call, args, kw in (
        ("align_top_k", ("MKV",), dict(k=-1)),
        ("align_top_k", ("MKV",), dict(algorithm="xx")),
        ("align_top_k", ("MKV",), dict(overflow="xx")),
        ("align_top_k", (None,), {}),
        ("align_top_k", ("MKV", "other"), {}),
        ("align_top_k", ("MKV", "alphabet"), {}),
        ("align_top_k", ("MKV",), dict(start=-1)),
        ("align", ("MKV",), dict(mode="fast")),
        ("align_arrays", (["MKV"],), dict(mode="fast")),
    ):
        def run(aligner, database, alien):
            a = list(args)
            if len(a) == 1:
                a.append(database)
            elif a[1] == "alphabet":
                a[1] = alien
            return getattr(aligner, call)(*a, **kw)

        with pytest.raises(Exception) as ref_err:
            run(ref_al, ref_db, ref_other)
        with pytest.raises(type(ref_err.value)) as err:
            run(al, db, other)
        assert str(err.value) == str(ref_err.value), (call, kw)


def test_streams_and_pickling():
    al = pt.Aligner("BLOSUM62", gap_open=5, gap_extend=2, device="cpu")
    clone = pickle.loads(pickle.dumps(al))
    assert clone == al and clone.device == al.device
    db = pt.Database(["MKVLAT", "MKV", "AAAA"])
    queries = ["MKV", "LAT", "KVLA"]
    batch = al.align_batch(queries, db, mode="end")
    assert list(al.align_many(queries, db, mode="end", batch_size=2)) == batch
    futures = [al.align_async(q, db, mode="end") for q in queries]
    assert [f.result() for f in futures] == batch
    assert [al.align(q, db, mode="end") for q in queries] == batch


@pytest.mark.parametrize("args, want", [
    (("sw", False, 3, 1, 15, 64), True),  # BLOSUM50 3/1, tiers 64-512
    (("sw", False, 3, 1, 15, 128), True),
    (("sw", False, 3, 1, 15, 256), True),
    (("sw", False, 3, 1, 15, 512), True),
    (("sw", True, 3, 1, 15, 256), False),  # end mode
    (("nw", False, 3, 1, 15, 256), False),
    (("hw", False, 3, 1, 15, 256), False),
    (("ov", False, 3, 1, 15, 256), False),
    (("sw", False, 3, 1, 1025, 16), False),  # an entry past the clamp
    (("sw", False, 3, 1, 495, 64), True),  # cap 31,680: H + s + go 32,704
    (("sw", False, 3, 1, 496, 64), False),  # cap 31,744: past int16
    (("sw", False, 3, 1, 250, 128), False),  # a tier past the bound
    (("sw", False, 500, 12, 15, 256), True),  # go + ge = 512: the floor
    (("sw", False, 500, 13, 15, 256), False),
    (("sw", False, -1, 2, 15, 256), False),
    (("sw", False, 3, -1, 15, 256), False),
])
def test_packed_exact_domain_edges(args, want):
    """The static predicate of K2's packed route: (algorithm, with_ends,
    go, ge, max |S|, Q_pad)."""
    assert engine._packed_exact_domain(*args) is want


#: Swiss-Prot's lanes (405,632) and the 12,071-sequence database's (12,160)
SP, SP12 = 405632, 12160


@pytest.mark.parametrize("args, want", [
    # BLOSUM62 12/2 (max |S| 11): tier 4096 and a fine tier hold T_max
    # 2,885 (cap 31,735), not 2,886; tiers up to 2048 cap at their rows
    (("sw", False, 12, 2, 11, 4096, 2885, True, 1, SP), 31735),
    (("sw", False, 12, 2, 11, 4096, 2886, True, 1, SP), None),
    (("sw", False, 12, 2, 11, 5120, 2885, True, 1, SP), 31735),
    (("sw", False, 12, 2, 11, 5632, 2886, True, 1, SP), None),
    (("sw", False, 12, 2, 11, 2048, 35213, True, 4, SP), 22528),
    (("sw", False, 12, 2, 11, 64, 2719, True, 1, SP), 704),
    (("sw", False, 12, 2, 11, 256, 0, True, 1, SP), 0),  # an empty slice
    # BLOSUM50 3/1 (max |S| 15): T_max 2,116, not 2,117
    (("sw", False, 3, 1, 15, 4096, 2116, True, 1, SP), 31740),
    (("sw", False, 3, 1, 15, 4096, 2117, True, 1, SP), None),
    (("sw", True, 12, 2, 11, 256, 1000, True, 1, SP), None),  # end mode
    (("nw", False, 12, 2, 11, 256, 1000, True, 1, SP), None),
    (("hw", False, 12, 2, 11, 256, 1000, True, 1, SP), None),
    (("ov", False, 12, 2, 11, 256, 1000, True, 1, SP), None),
    (("sw", False, -1, 2, 11, 256, 1000, True, 1, SP), None),
    (("sw", False, 12, -1, 11, 256, 1000, True, 1, SP), None),
    (("sw", False, 12, 2, 11, 256, 1000, False, 1, SP), None),  # 32 columns
    (("sw", False, 12, 2, 1025, 16, 16, True, 1, SP), None),  # the clamp
    # the launch's blocks (256 / G pairs a block) against one wave, 264:
    # one query at the 128 tier on 12,160 lanes is 190, two are 380; at
    # the 256 tier one is 380; at the 64 tier three are 285
    (("sw", False, 3, 1, 15, 128, 1827, True, 1, SP12), None),
    (("sw", False, 3, 1, 15, 128, 1827, True, 2, SP12), 1920),
    (("sw", False, 3, 1, 15, 256, 1827, True, 1, SP12), 3840),
    (("sw", False, 3, 1, 15, 64, 1827, True, 2, SP12), None),
    (("sw", False, 3, 1, 15, 64, 1827, True, 3, SP12), 960),
])
def test_ragged_packed_cap_edges(args, want):
    """The static route of K1's packed walk: (algorithm, with_ends, go,
    ge, max |S|, Q_pad, longest target, safe_pad, queries, lanes) -> H's
    cap, or None for K1's int32 walk."""
    assert engine._ragged_packed_cap(*args) == want


@pytest.mark.parametrize("mode", ["score", "end"])
def test_k1_cohorts_and_fine_tier_take_the_packed_walk_in_score_mode(
        monkeypatch, mode):
    """Through `Aligner.align_batch` on the CPU (BLOSUM62 12/2; the
    route's floor of blocks lowered to one for a small database): a K1
    cohort at tier 128 and a 4,100-residue query at its fine tier take
    K1's packed route in sw score mode (its plain version) and K1's
    int32 walk in end mode, with the same scores."""
    monkeypatch.setattr(engine, "_PACKED_MIN_BLOCKS", 1)
    rng = np.random.default_rng(19)
    al = pt.Aligner("BLOSUM62", gap_open=12, gap_extend=2, device="cpu")
    plain = al.alphabet.letters[:20]
    targets = ["".join(rng.choice(list(plain), n)) for n in (0, 1, 9, 30)]
    queries = ["".join(rng.choice(list(plain), n)) for n in (4100, 70, 90)]
    db = pt.Database(targets)
    before = dict(ragged.plain_calls)
    got = al.align_batch(queries, db, mode=mode)
    k1 = "ragged_packed" if mode == "score" else "ragged"
    before[k1] += 2
    assert ragged.plain_calls == before
    S = al.scoring_matrix.int_data()
    enc = lambda s: np.frombuffer(db.alphabet.encode(s), np.uint8)  # noqa
    for qq, hits in zip(queries, got):
        for r, t in zip(hits, targets):
            assert r.score == naive.score_end(enc(qq), enc(t), S, 12, 2,
                                              "sw")[0]


def _q8_fuzz_batch(seed):
    """`_case(seed)`'s alphabet, matrix and gaps, with 24 targets of the
    fuzz lengths and 15 queries of the 128 tier (a full q8 group and one
    of 7 slots), of lengths fixed across seeds so that the reference
    compiles its search once for seeds of one alphabet size."""
    letters, m, go, ge, algo, mode, _, _ = _case(seed)
    rng = random.Random(seed ^ 0x0A8)
    alpha = letters[: max(len(letters) - 1, 1)]
    targets = ["".join(rng.choices(alpha, k=k))
               for k in [0, 1, 2, 17, 63, 64, 65, 130] * 3]
    queries = ["".join(rng.choices(alpha, k=65 + 4 * i)) for i in range(15)]
    return letters, m, go, ge, algo, mode, targets, queries


@pytest.mark.parametrize("seed, packed", [
    (0, True),  # max |S| 17: cap 2,176
    (24, True),  # max |S| 235: cap 30,080
    (9, False),  # max |S| 248: cap 31,744, one past int16's reach
    (11, False),  # max |S| 249, gaps 11/7
])
def test_q8_groups_take_the_packed_walk_in_sw_score_mode(seed, packed):
    """On seeded fuzz configurations: sw score and end mode equal
    `pyopal_tpu`'s, and the counters show both q8 groups on the packed
    walk in sw score mode where Q_pad x max |S| + 1,024 stays within
    int16, on K2's int32 walk in end mode, past that bound and in the
    case's own algorithm when it is not sw."""
    from torch.profiler import ProfilerActivity, profile

    from pyopal_tpu_torch.utils import profiling

    letters, m, go, ge, algo, mode, targets, queries = _q8_fuzz_batch(seed)
    assert len(letters) == 24
    assert (128 * int(np.abs(m).max()) <= 31743) is packed
    ref_al, ref_db, al, db = _both(letters, m, go, ge, targets)
    ref = ref_al.align_arrays(queries, ref_db, mode="end", algorithm="sw")
    calls = [("sw", "score"), ("sw", "end")]
    calls += [(algo, mode)] if algo != "sw" else []
    for a, md in calls:
        profiling.reset_counters()
        with profile(activities=[ProfilerActivity.CPU]):
            got = al.align_arrays(queries, db, mode=md, algorithm=a)
        counted = profiling.counters()
        if a == "sw":
            for key in got:
                np.testing.assert_array_equal(got[key], ref[key],
                                              err_msg=key)
        walk = ("q8.groups_packed" if packed and (a, md) == ("sw", "score")
                else "q8.groups_wide")
        assert {k: v for k, v in counted.items() if k.startswith("q8.")} == {
            walk: 2}


B50 = pt.ScoringMatrix.from_name("BLOSUM50").int_data()
ROUTE_MATRICES = {
    "BLOSUM50": B50,
    "32 columns": np.pad(B50, ((0, 8), (0, 8))),
    "entry 300": np.where(np.eye(24, dtype=bool), 300, B50),
}


@pytest.mark.parametrize("name", sorted(ROUTE_MATRICES))
@pytest.mark.parametrize("past_fp32", [False, True])
def test_kernel_route_partitions_as_before(name, past_fp32):
    """`engine.kernel_route` splits queries as the engine, the sharded
    search and the sharded top-k each did with their own predicate
    (frozen here), over matrices, gaps, modes and query lengths around
    `ragged.supports`' limits; with ``past_fp32`` the slice holds a
    target long enough that `_fp32_exact_domain` fails."""
    matrix = ROUTE_MATRICES[name]
    # 1.2 M residues: span x 15 alone passes 2**24
    db = pt.Database(["ACDEF", "W" * 300, "A" * 1_200_000])
    start, end = 0, 3 if past_fp32 else 2
    rng = np.random.default_rng(7)
    queries = [rng.integers(0, 20, n).astype(np.uint8)
               for n in (4097, 0, 1, 5000, 4096, 1, 0)]

    def old_engine(go, ge, algo, with_ends):
        use = np.abs(matrix).max(initial=0) <= 256 and (
            engine._fp32_exact_domain(db, start, end, queries, matrix, go,
                                      ge))
        safe_pad = matrix.shape[1] <= 31
        ok = [use and ragged.supports(q.shape[0], algo, with_ends, safe_pad)
              for q in queries]
        return (
            safe_pad,
            [i for i, k in enumerate(ok) if k],
            [i for i, q in enumerate(queries)
             if use and q.shape[0] > 0 and not ok[i]],
            [i for i, q in enumerate(queries) if not use and q.shape[0] > 0],
            [i for i, q in enumerate(queries) if q.shape[0] == 0],
        )

    def old_sharded(go, ge, algo, with_ends):
        use_mesh = (
            np.abs(matrix).max(initial=0) <= 256
            and matrix.shape[1] <= 31
            and engine._fp32_exact_domain(db, start, end, queries, matrix,
                                          go, ge)
        )
        return [i for i, q in enumerate(queries) if use_mesh
                and ragged.supports(q.shape[0], algo, with_ends, True)]

    def old_top_k(go, ge, algo):
        safe_pad = matrix.shape[1] <= 31
        use_mesh = np.abs(matrix).max(initial=0) <= 256 and (
            engine._fp32_exact_domain(db, start, end, queries, matrix, go,
                                      ge))
        return [i for i, q in enumerate(queries) if use_mesh
                and q.shape[0] > 0
                and ragged.supports(q.shape[0], algo, True, safe_pad)]

    seen = set()
    with db.lock.read:
        for (go, ge), algo, with_ends in itertools.product(
            [(3, 1), (12, 2), (-1, 2), (0, 0)], ["sw", "nw"],
            [False, True],
        ):
            route = engine.kernel_route(db, start, end, queries, matrix, go,
                                        ge, algo, with_ends)
            assert route.m_abs == np.abs(matrix).max()
            assert (route.safe_pad, route.kernel, route.long, route.sweep,
                    route.empty) == old_engine(go, ge, algo, with_ends)
            mesh = route.kernel if route.safe_pad else []
            assert mesh == old_sharded(go, ge, algo, with_ends)
            if with_ends:
                assert route.kernel == old_top_k(go, ge, algo)
            seen.update(k for k in ("kernel", "long", "sweep")
                        if getattr(route, k))
    # every case reaches the routes its matrix and slice allow
    inside = name != "entry 300" and not past_fp32
    assert seen == ({"kernel", "long", "sweep"} if inside else {"sweep"})
