"""Data and queries from the seed: the length multiset is fixed by the
configuration, the seed picks residues, and no call repeats a query."""

import json

import numpy as np
import pytest

from benchmark import generate
from benchmark.tests import fixture_cell

CONFIGS = fixture_cell.BENCH / "configs"
TRAFFIC = fixture_cell.BENCH / "traffic"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize(
    "name,count,residues",
    [("sprot12071-blosum50", 12071, 4683440),
     ("swissprot-blosum62", 405506, 146166984)],
)
def test_length_multiset_fixed(name, count, residues):
    a = generate.database_lengths(config(name)["database"])
    b = generate.database_lengths(config(name)["database"])
    assert a.shape[0] == count and int(a.sum()) == residues
    assert np.array_equal(a, b)
    assert a.min() >= 30 and a.max() <= 4000


def test_sprot12071_is_bench_py_draw():
    rng = np.random.default_rng(12071)
    want = np.clip(rng.lognormal(np.log(350), 0.45, 12071).astype(int), 30, 4000)
    got = generate.database_lengths(config("sprot12071-blosum50")["database"])
    assert np.array_equal(got, want)


def test_seed_picks_residues():
    a = generate.database_codes(5000, 2**31 + 3, "cpu")
    b = generate.database_codes(5000, 2**31 + 3, "cpu")
    c = generate.database_codes(5000, 2**31 + 4, "cpu")
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.max() < 20


@pytest.mark.parametrize("traffic", ["batch256", "query", "cudasw20", "proteome64"])
def test_queries_fresh_and_seeded(traffic):
    t = json.loads((TRAFFIC / f"{traffic}.json").read_text())
    lengths = generate.database_lengths(fixture_cell.tiny_database(count=400, clip=(30, 6000), median=3000))
    codes = generate.database_codes(int(lengths.sum()), 5, "cpu")
    s1 = generate.QueryStream(t, lengths, codes, 5, generate.STREAM_WINDOW)
    s2 = generate.QueryStream(t, lengths, codes, 5, generate.STREAM_WINDOW)
    warm = generate.QueryStream(t, lengths, codes, 5, generate.STREAM_WARMUP)
    other = generate.QueryStream(t, lengths, codes, 6, generate.STREAM_WINDOW)
    seen = set()
    for k in range(12):
        c = s1.call(k)
        assert c.letters == s2.call(k).letters
        assert [len(q) for q in c.letters] == s1.lengths(k)
        for q in c.letters + warm.call(k).letters:
            assert q not in seen
            seen.add(q)
    assert other.call(0).letters != s1.call(0).letters
    assert all(set(q) <= set(generate.LETTERS) for q in seen)


def test_proteome_lengths_are_quantiles():
    t = json.loads((TRAFFIC / "proteome64.json").read_text())
    lengths = generate.database_lengths(config("sprot12071-blosum50")["database"])
    q = generate.query_lengths(t, lengths)
    assert len(q) == 64 and q == sorted(q)
    assert q[0] >= lengths.min() and q[-1] <= lengths.max()


def test_windows_are_homologs():
    t = json.loads((TRAFFIC / "batch256.json").read_text())
    lengths = generate.database_lengths(fixture_cell.tiny_database())
    codes = generate.database_codes(int(lengths.sum()), 9, "cpu")
    call = generate.QueryStream(t, lengths, codes, 9, 0).call(0)
    for start, q in zip(call.starts, call.codes):
        same = (codes[start : start + q.shape[0]] == q).mean()
        assert 0.6 < same < 0.8
