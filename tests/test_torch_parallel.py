"""The sharded path against `pyopal_tpu.parallel`, on the CPU.

`pyopal_tpu_torch.parallel.align_arrays_sharded` over a 4-shard CPU mesh
(the kernels' plain versions on every shard) must equal the reference's
`align_arrays_sharded` over 4 of the 8 virtual CPU devices of
``tests/conftest.py``, with tolerance 0: both compute integer DP.  The
packing, the group search (against both of the reference's routes) and
the top-k merge are held against the reference function by function, and a two-process
``gloo`` group against the single-process result, as
``tests/test_multiprocess.py`` does for JAX.

Run as a script (``python tests/test_torch_parallel.py <rank> <init
file> <out file>``), this file is one rank of that two-process group.
"""

import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import pyopal_tpu as po
import pyopal_tpu_torch as pt
from pyopal_tpu.ops import pallas_kernel as pk
from pyopal_tpu.ops import xla as ref_xla
from pyopal_tpu.parallel import align_arrays_sharded as ref_sharded
from pyopal_tpu.parallel import align_top_k_sharded as ref_top_k_sharded
from pyopal_tpu.parallel import device_mesh as ref_mesh
from pyopal_tpu.parallel import sharded as ref_sh
from pyopal_tpu.parallel import sharded_flat as ref_sfm
from pyopal_tpu_torch.ops import group, packing, q8, ragged, sweep
from pyopal_tpu_torch.parallel import (
    align_arrays_sharded,
    align_top_k_sharded,
    device_mesh,
    local_shards_of_mesh,
    sharded as sh,
    sharded_flat as sfm,
)
import _torch_cpu  # torch threads: a worker's share, also for subprocesses

AMINO = "ARNDCQEGHILKMFPSTWYV"
ALGOS = ["nw", "hw", "ov", "sw"]
S = pt.ScoringMatrix.from_name("BLOSUM50").int_data()


def _random_seqs(n, lo, hi, seed):
    rng = random.Random(seed)
    return ["".join(rng.choice(AMINO) for _ in range(rng.randint(lo, hi)))
            for _ in range(n)]


def _dbs(seqs, alphabet=None):
    return pt.Database(seqs, alphabet=alphabet), po.Database(seqs,
                                                             alphabet=alphabet)


def _mesh4():
    return device_mesh(4, device="cpu")


def _check(queries, seqs, alphabet=None, ref_matrix=None, **kw):
    """The port's sharded call against the reference's, array by array
    (``ref_matrix``: the reference's copy of ``scoring_matrix``)."""
    db, ref_db = _dbs(seqs, alphabet)
    ref_kw = dict(kw)
    if ref_matrix is not None:
        ref_kw["scoring_matrix"] = ref_matrix
    got = align_arrays_sharded(queries, db, mesh=_mesh4(), **kw)
    want = ref_sharded(queries, ref_db, mesh=ref_mesh(4), **ref_kw)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == (object if key == "cigars" else np.int32), key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _calls():
    return (ragged.plain_calls["ragged"], q8.plain_calls["q8"],
            sweep.launches)


@pytest.mark.parametrize(
    "algo, mode",
    [(a, m) for a in ALGOS for m in ("score", "end")]
    + [("sw", "full"), ("ov", "full")])
def test_sharded_matches_reference(algo, mode):
    """Mixed tiers: one full q8 group and a K1 leftover at tier 64, a K1
    query at tier 128, beside an empty query; each kernel cohort runs
    once per shard.  Full mode at sw (empty local alignments) and ov
    (free ends on both sides); `tests/test_torch_traceback.py` covers
    the traceback at every algorithm."""
    queries = (_random_seqs(9, 30, 60, seed=2) + [""]
               + _random_seqs(1, 70, 120, seed=3))
    before = _calls()
    _check(queries, _random_seqs(60, 0, 32, seed=1), algorithm=algo,
           mode=mode)
    after = _calls()
    assert [a - b for a, b in zip(after, before)] == [2 * 4, 4, 0]


@pytest.mark.parametrize("mode", ["score", "end"])
def test_sharded_k1_asks_the_engines_packed_predicate(monkeypatch, mode):
    """`align_arrays_sharded` asks `engine._ragged_packed_cap` for each
    shard's K1 launch, with that shard's longest target and lanes (its
    floor of blocks lowered to one for small shards): in sw score mode
    every shard takes K1's packed route (its plain version here), in end
    mode K1's int32 walk, and the arrays equal `Aligner.align_arrays`."""
    from pyopal_tpu_torch.ops import engine

    asked = []
    real = engine._ragged_packed_cap

    def spy(*args):
        asked.append(args)
        return real(*args)

    monkeypatch.setattr(engine, "_ragged_packed_cap", spy)
    monkeypatch.setattr(engine, "_PACKED_MIN_BLOCKS", 1)  # small shards
    seqs = _random_seqs(60, 0, 90, seed=5)
    queries = _random_seqs(2, 70, 120, seed=6)  # a K1 cohort at tier 128
    db = pt.Database(seqs)
    before = dict(ragged.plain_calls)
    got = align_arrays_sharded(queries, db, mode=mode, mesh=_mesh4())
    calls = [ragged.plain_calls[k] - before[k]
             for k in ("ragged", "ragged_packed")]
    assert calls == ([0, 4] if mode == "score" else [4, 0])
    sf = sfm.pack_flat_sharded([np.zeros(len(t), np.uint8) for t in seqs], 4)
    assert sorted((a[6], a[9]) for a in asked) == sorted(
        (int(sf.lengths[s].max()), sf.lengths[s].size) for s in range(4))
    assert {a[:6] + a[7:9] for a in asked} == {
        ("sw", mode == "end", 3, 1, 15, 128, True, 2)}
    want = pt.Aligner(device="cpu").align_arrays(queries, db, mode=mode)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_slice_and_fewer_targets_than_shards():
    seqs = _random_seqs(40, 10, 60, seed=12)
    queries = _random_seqs(4, 15, 40, seed=13)
    _check(queries, seqs, mode="end", start=7, end=31)
    _check(queries, seqs, mode="end", start=35, end=10_000)
    # 3 targets over 4 shards: one shard packs an empty layout
    _check(queries, ["AACCGCTG", "ATGCGCT", "TTATTACG"], mode="end")


def test_fallback_routes():
    """A matrix beyond +-256 and negative gap penalties leave the kernels
    for the single-device engine's sweep, on the mesh's device."""
    big = pt.ScoringMatrix.from_match_mismatch(500, -400, AMINO)
    seqs = _random_seqs(6, 5, 20, seed=72)
    queries = _random_seqs(3, 4, 10, seed=73)
    before = _calls()
    _check(queries, seqs, alphabet=big.alphabet, scoring_matrix=big,
           ref_matrix=po.ScoringMatrix.from_match_mismatch(500, -400, AMINO))
    _check(queries, seqs, gap_open=-2, gap_extend=-1, mode="end")
    _check(["", "ACGTR"], seqs, algorithm="nw", mode="end")
    after = _calls()
    assert [a - b for a, b in zip(after, before)] == [4, 0, 3 + 3]


def test_long_query_takes_the_single_device_engine():
    """A query beyond 4096 residues takes one K1 launch at its fine tier
    (here its plain version), not the shards; the rest of the batch
    stays on the mesh."""
    seqs = _random_seqs(20, 5, 60, seed=30)
    queries = _random_seqs(1, 4200, 4200, seed=31) + _random_seqs(
        2, 20, 40, seed=32)
    db = pt.Database(seqs)
    before = _calls()
    got = align_arrays_sharded(queries, db, mode="end", mesh=_mesh4())
    after = _calls()
    assert [a - b for a, b in zip(after, before)] == [4 + 1, 0, 0]
    want = pt.Aligner(device="cpu").align_arrays(queries, db, mode="end")
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_validation_errors_match_reference():
    db, ref_db = _dbs(_random_seqs(5, 10, 20, seed=18))
    other = pt.Database(["ACGT"], alphabet=pt.Alphabet("ACGT"))
    ref_other = po.Database(["ACGT"], alphabet=po.Alphabet("ACGT"))
    for kw in (
        dict(mode="banana"),
        dict(algorithm="bogus"),
        dict(start=-1),
        dict(start=4, end=2),
    ):
        with pytest.raises(Exception) as ref_err:
            ref_sharded(["ACDEF"], ref_db, mesh=ref_mesh(4), **kw)
        with pytest.raises(type(ref_err.value)) as err:
            align_arrays_sharded(["ACDEF"], db, mesh=_mesh4(), **kw)
        assert str(err.value) == str(ref_err.value)
    with pytest.raises(ValueError) as ref_err:
        ref_sharded(["ACDEF"], ref_other, mesh=ref_mesh(4))
    with pytest.raises(ValueError) as err:
        align_arrays_sharded(["ACDEF"], other, mesh=_mesh4())
    assert str(err.value) == str(ref_err.value)
    for kw in (dict(k=-1), dict(algorithm="zz"), dict(gap_open="x")):
        with pytest.raises(Exception) as ref_err:
            ref_top_k_sharded(["AA"], ref_db, mesh=ref_mesh(4), **kw)
        with pytest.raises(type(ref_err.value)) as err:
            align_top_k_sharded(["AA"], db, mesh=_mesh4(), **kw)
        assert str(err.value) == str(ref_err.value)
    with pytest.raises(ValueError) as ref_err:
        ref_top_k_sharded(["AA"], ref_other, mesh=ref_mesh(4))
    with pytest.raises(ValueError) as err:
        align_top_k_sharded(["AA"], other, mesh=_mesh4())
    assert str(err.value) == str(ref_err.value)
    assert align_top_k_sharded([], db, k=3, mesh=_mesh4()) == []
    assert align_top_k_sharded(["AA"], pt.Database(), k=3,
                               mesh=_mesh4()) == [[]]
    assert align_top_k_sharded(["AA"], db, k=0, mesh=_mesh4()) == [[]]


def test_empty_inputs_and_doctest_scores():
    db, ref_db = _dbs(_random_seqs(10, 10, 20, seed=15))
    cpu = device_mesh(device="cpu")
    out = align_arrays_sharded([], db, mesh=cpu)
    assert out["scores"].shape == (0, 10)
    out = align_arrays_sharded(["ACDEF"], pt.Database([]), mode="end",
                               mesh=cpu)
    assert out["scores"].shape == out["query_ends"].shape == (1, 0)
    toy = pt.Database(["AACCGCTG", "ATGCGCT", "TTATTACG"])
    out = align_arrays_sharded(["ACCTG"], toy, gap_open=2, mesh=cpu)
    assert out["scores"][0].tolist() == [41, 31, 23]


def test_pack_cached_across_calls():
    db = pt.Database(_random_seqs(20, 10, 30, seed=16))
    queries = _random_seqs(2, 10, 20, seed=17)
    align_arrays_sharded(queries, db, mesh=_mesh4())
    before = {k: id(v) for k, v in db._pack_cache.items()
              if k[0] == "sharded"}
    assert before
    align_arrays_sharded(queries, db, mesh=_mesh4())
    assert before == {k: id(v) for k, v in db._pack_cache.items()
                      if k[0] == "sharded"}
    db.append("ACDEF")  # mutation invalidates: the version key changes
    align_arrays_sharded(queries, db, mesh=_mesh4())
    assert all(k not in db._pack_cache for k in before)


@pytest.mark.parametrize("lanes", [128, 512])
@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_pack_flat_sharded_matches_reference(n_shards, lanes):
    rng = np.random.default_rng(n_shards * lanes)
    seqs = [rng.integers(0, 20, int(n)).astype(np.uint8)
            for n in rng.integers(0, 200, 700)]
    lens = [len(s) for s in seqs]
    assert sfm.shard_assignment(len(seqs), lens, n_shards, lanes) == (
        ref_sfm.shard_assignment(len(seqs), lens, n_shards, lanes))
    for local in (None, (n_shards - 1,)):
        got = sfm.pack_flat_sharded(seqs, n_shards, lanes, local)
        ref = ref_sfm.pack_flat_sharded(seqs, n_shards, lanes, local)
        for name in ("n_targets", "n_shards", "rows_max", "lanes", "chunk",
                     "local_shards", "local_payload_bytes"):
            assert getattr(got, name) == getattr(ref, name), name
        for name in ("lengths", "block_of_step", "chunk_of_step",
                     "last_of_step", "inv_shard", "inv_pos"):
            a, b = getattr(got, name), getattr(ref, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name
        assert sorted(got.payloads) == sorted(ref.payloads)
        for s, p in ref.payloads.items():
            assert got.payloads[s].dtype == np.uint8
            assert got.payloads[s].tobytes() == p.tobytes(), s


def test_sharded_search_flat_needs_local_payloads():
    seqs = [np.arange(n, dtype=np.uint8) % 20 for n in (5, 9, 30)]
    sf = sfm.pack_flat_sharded(seqs, 2, local_shards=(0,))
    profs = ragged.make_profiles_host([seqs[2]], S)
    mesh = device_mesh(2, device="cpu")
    assert local_shards_of_mesh(mesh) == (0, 1)
    with pytest.raises(ValueError, match=r"missing payloads .*\[1\]"):
        sfm.sharded_search_flat(mesh, profs, np.array([30], np.int32), sf,
                                3, 1, "sw")


@pytest.mark.parametrize("algo, with_ends, safe_pad", [
    ("nw", False, False), ("ov", False, False), ("sw", True, False),
    ("nw", False, True),
])
def test_sharded_search_flat_defaults_match_reference(algo, with_ends,
                                                      safe_pad):
    """`sharded_search_flat` at its defaults runs the reference's default,
    ``safe_pad=False``: K4 on every shard (here its plain version), whose
    score-mode end planes differ from K1's (nw: query end ``Q - 1`` and
    target end ``len - 1``; ov: the last row's or the last column's end).
    Against the reference's interpreted kernels on its 4-device mesh, all
    three planes, and with ``safe_pad=True`` (K1, -1 planes)."""
    import jax.numpy as jnp

    from pyopal_tpu.ops import pallas_ragged as pr

    rng = np.random.default_rng(9)
    seqs = [rng.integers(0, 24, int(n)).astype(np.uint8)
            for n in [0, 5, 40, 63, 130] + list(rng.integers(1, 150, 300))]
    queries = [rng.integers(0, 24, 30).astype(np.uint8)]
    queries[0][5:25] = seqs[2][10:30]
    profs = ragged.make_profiles_host(queries, S)
    qlens = np.array([30], np.int32)
    sf = sfm.pack_flat_sharded(seqs, 4)
    kw = {"safe_pad": True} if safe_pad else {}
    calls = dict(ragged.plain_calls)
    got = sfm.sharded_search_flat(_mesh4(), profs, qlens, sf, 3, 1, algo,
                                  with_ends, **kw)
    calls = [ragged.plain_calls[k] - calls[k] for k in ("ragged",
                                                        "ragged_v1")]
    assert calls == ([4, 0] if safe_pad else [0, 4])
    want = ref_sfm.sharded_search_flat(
        ref_mesh(4), jnp.asarray(profs, jnp.bfloat16), jnp.asarray(qlens),
        ref_sfm.pack_flat_sharded(seqs, 4), 3, 1, algo, with_ends,
        interpret=True, **kw,
    )
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))
    if algo == "nw" and not with_ends:
        lens = np.array([len(t) for t in seqs])
        q_end, t_end = (-1, -1) if safe_pad else (29, lens - 1)
        assert (got[1] == q_end).all() and (got[2] == t_end).all()


def _group_of(seqs, n_shards):
    """The largest group of the grouped pack, blocks padded for the
    shards: (targets, lengths, indices)."""
    packed = packing.pack_sequences(seqs)
    g = max(packed.groups, key=lambda g: g.targets.shape[0])
    targets, lengths = sh.pad_blocks(g.targets, g.lengths, n_shards)
    ref_t, ref_l = ref_sh.pad_blocks(g.targets, g.lengths, n_shards)
    assert targets.tobytes() == ref_t.tobytes()
    assert lengths.tobytes() == ref_l.tobytes()
    return targets, lengths, g.indices


@pytest.mark.parametrize("algo, with_ends", [("sw", True), ("ov", False)])
def test_sharded_search_group_matches_reference(algo, with_ends):
    """The port's one route (K6's plain version on 4 CPU shards) against
    the reference's two: the interpreted kernel over the whole group, and
    the sweep route on its 4-device mesh (which returns ends in both
    modes, so only its scores are held in score mode)."""
    rng = np.random.default_rng(40)
    seqs = [rng.integers(0, 20, int(n)).astype(np.uint8)
            for n in rng.integers(0, 60, 500)]
    targets, lengths, _ = _group_of(seqs, 4)
    assert targets.shape[0] % 4 == 0 and targets.shape[0] >= 4
    q = rng.integers(0, 20, 21).astype(np.uint8)
    mesh = _mesh4()
    prof = (group.make_profile_host(q, S), len(q))

    before = (group.plain_calls, sweep.launches)
    got = sh.sharded_search_group(mesh, prof, targets, lengths, 3, 1, algo,
                                  with_ends)
    assert (group.plain_calls, sweep.launches) == (before[0] + 4, before[1])
    want = pk.search_group(pk.make_profile(q, S), targets.astype(np.int32),
                           lengths, 3, 1, algo, with_ends, interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))

    want = ref_sh.sharded_search_group(
        ref_mesh(4), ref_xla.make_profile_t(q, S), targets.astype(np.int32),
        lengths, 3, 1, algo, with_ends, use_pallas=False)
    for g, w in list(zip(got, want))[: 3 if with_ends else 1]:
        np.testing.assert_array_equal(g, np.asarray(w))
    with pytest.raises(ValueError, match="split evenly"):
        sh.sharded_search_group(device_mesh(3, device="cpu"), prof,
                                targets[:4], lengths[:4], 3, 1, algo)


def test_top_k_merge_matches_reference():
    """Deliberate ties, inside a shard and across shards: both merges
    keep the lower position first."""
    rng = np.random.default_rng(7)
    scores = rng.integers(0, 6, 64).astype(np.int32)
    scores[[3, 17, 40, 41]] = 9
    indices = np.arange(64, dtype=np.int32)[::-1].copy()
    for k in (1, 5, 12, 16, 40):
        v, i = sh.top_k_merge(_mesh4(), scores, indices, k)
        rv, ri = ref_sh.top_k_merge(ref_mesh(4), scores, indices, k)
        assert v.dtype == np.int32 and i.dtype == np.int32
        np.testing.assert_array_equal(v, np.asarray(rv))
        np.testing.assert_array_equal(i, np.asarray(ri))
        top = np.argsort(-scores, kind="stable")[: min(k, 16 * 4)]
        np.testing.assert_array_equal(v, scores[top])


def _full(results):
    return [
        (r.target_index, r.score, r.query_end, r.target_end, r.query_start,
         r.target_start, r.query_length, r.target_length, r.alignment)
        for r in results
    ]


def _check_top_k(queries, seqs, k, gathers=None, **kw):
    """`align_top_k_sharded` over 4 CPU shards against the reference's
    single-device `align_top_k`, result by result; ``gathers``: the
    candidate gathers the call must make."""
    db, ref_db = _dbs(seqs)
    made = []
    real = sfm.sharded_topk_candidates

    def counted(*args):
        made.append(args[-1])
        return real(*args)

    sfm.sharded_topk_candidates = counted
    try:
        got = align_top_k_sharded(queries, db, k=k, mesh=_mesh4(), **kw)
    finally:
        sfm.sharded_topk_candidates = real
    ref_al = po.Aligner(gap_open=kw.get("gap_open", 3),
                        gap_extend=kw.get("gap_extend", 1))
    al = pt.Aligner(gap_open=kw.get("gap_open", 3),
                    gap_extend=kw.get("gap_extend", 1), device="cpu")
    algo = kw.get("algorithm", "sw")
    assert len(got) == len(queries)
    for qi, q in enumerate(queries):
        want = _full(ref_al.align_top_k(q, ref_db, k=k, algorithm=algo))
        assert _full(got[qi]) == want, qi
        assert _full(al.align_top_k(q, db, k=k, algorithm=algo)) == want
    if gathers is not None:
        assert len(made) == gathers, made
    return made


@pytest.mark.parametrize("algo, k", [("sw", 13), ("nw", 7), ("ov", 7),
                                     ("hw", 150)])
def test_top_k_sharded_matches_reference(algo, k):
    """The candidate pipeline (per-shard `torch.topk`, the gather, the
    exact host merge): one gather per cohort, ``k`` past the database
    size included (hw)."""
    seqs = _random_seqs(120 if k == 150 else 300, 5, 120, seed=11)
    _check_top_k(_random_seqs(3, 40, 60, seed=12), seqs, k, gathers=1,
                 algorithm=algo)


def test_top_k_sharded_tie_escalation():
    """Many identical targets put equal scores across every shard's
    candidate floor: the merge escalates to every shard's whole list (a
    second gather) and still picks the k smallest global indices among
    the ties (``tests/test_sharded_api.py``'s construction)."""
    rng = random.Random(17)
    base = "".join(rng.choice(AMINO) for _ in range(40))
    targets = [base] * 120 + [
        "".join(rng.choice(AMINO) for _ in range(rng.randint(10, 80)))
        for _ in range(80)
    ]
    rng.shuffle(targets)
    made = _check_top_k([base], targets, 15, gathers=2)
    assert made[0] == 15 and made[1] > 15


def test_top_k_sharded_mixed_tiers_and_fallbacks():
    """Queries of 70, 140 and 210 residues (two tier cohorts), and an
    empty query and a 5,000-residue one, which take
    `engine.search_top_k`."""
    seqs = _random_seqs(150, 5, 100, seed=20)
    qs = ["".join(random.Random(21 + i).choice(AMINO)
                  for _ in range((i + 1) * 70)) for i in range(3)]
    _check_top_k(qs, seqs, 9, gathers=2)
    long_q = "".join(random.Random(18).choice(AMINO) for _ in range(5000))
    _check_top_k(["", long_q], seqs[:60], 5, gathers=0)


def test_device_mesh():
    mesh = device_mesh(4, device="cpu")
    assert mesh.n_shards == 4 and mesh.shape == {"db": 4}
    assert mesh.ranks == (0, 0, 0, 0) and mesh.rank == 0
    assert mesh.platform == "cpu"
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert device_mesh(device="cpu").n_shards == 1
    with pytest.raises(ValueError):
        device_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            device_mesh(2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            align_arrays_sharded(["ACDEF"], pt.Database(["ACDEF"]))


# --- two processes ------------------------------------------------------

MP_QUERIES = _random_seqs(11, 50, 50, seed=44) + [""]
MP_TARGETS = _random_seqs(300, 5, 120, seed=42)


def test_two_process_gloo_matches_single_process(tmp_path):
    """Two ranks of a ``gloo`` group, 2 of the 4 shards each, return the
    single-process result (``align_arrays_sharded``, and
    ``align_top_k_sharded``, whose candidates are gathered over the
    ranks), and each rank packs only its own shards' payloads (at most
    half of the packed bytes)."""
    want = align_arrays_sharded(MP_QUERIES, pt.Database(MP_TARGETS),
                                mode="end", mesh=_mesh4())
    want_top = align_top_k_sharded(MP_QUERIES[:2], pt.Database(MP_TARGETS),
                                   k=7, mesh=_mesh4())
    env = _torch_cpu.subprocess_env(JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + env.get("PYTHONPATH", "").split(os.pathsep))
    init = tmp_path / "rendezvous"
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(init),
             str(outs[r])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r in range(2)
    ]
    deadline = time.monotonic() + 120
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-3000:]}"
    for r in range(2):
        got = np.load(outs[r])
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert int(got["local_bytes"]) * 2 <= int(got["total_bytes"])
        assert json.loads(str(got["top_k"])) == [
            [list(t) for t in _full(x)] for x in want_top]


def _rank_main(rank, init, out):
    """One rank of the two-process test: 2 of 4 CPU shards."""
    from pyopal_tpu_torch.parallel import initialize_distributed

    initialize_distributed("gloo", f"file://{init}", world_size=2,
                           rank=rank)
    initialize_distributed("gloo", f"file://{init}", world_size=2,
                           rank=rank)  # a no-op once initialized
    mesh = device_mesh(4, device="cpu")
    assert mesh.ranks == (0, 0, 1, 1) and mesh.rank == rank
    local = set(local_shards_of_mesh(mesh))
    assert local == {2 * rank, 2 * rank + 1}
    db = pt.Database(MP_TARGETS)
    got = align_arrays_sharded(MP_QUERIES, db, mode="end", mesh=mesh)
    packs = [v for v in db._pack_cache.values()
             if isinstance(v, sfm.ShardedFlat)]
    assert len(packs) == 2  # the K2 (512-lane) and K1 (128-lane) packs
    # the candidate gather of top-k across the two ranks
    top = align_top_k_sharded(MP_QUERIES[:2], db, k=7, mesh=mesh)
    for sf in packs:
        assert set(sf.payloads) == local, sorted(sf.payloads)
    np.savez(
        out, **got, top_k=json.dumps(
            [[list(t) for t in _full(x)] for x in top]),
        local_bytes=sum(sf.local_payload_bytes for sf in packs),
        total_bytes=sum(sf.rows_max * sf.lanes * sf.n_shards for sf in packs),
    )
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
