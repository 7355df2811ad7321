"""K1's plain version against the reference ragged kernel.

`pyopal_tpu_torch.ops.ragged.search_flat` on CPU tensors runs the plain
PyTorch version of the CUDA kernel; it must equal
`pyopal_tpu.ops.pallas_ragged.search_flat` (the v2 kernel, interpreted
on the CPU) on the same profiles and flat arrays, on every lane, with
tolerance 0: both compute integer DP.  The CUDA kernel itself is held
against the plain version on the card (``test_torch_gpu.py`` and
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyopal_tpu.matrices import ScoringMatrix
from pyopal_tpu.ops import packing as ref_packing
from pyopal_tpu.ops import pallas_ragged as pr
from pyopal_tpu_torch.ops import engine, ragged
import _torch_cpu  # noqa: F401  (torch threads: a worker's share)

S = ScoringMatrix.from_name("BLOSUM50").int_data()
B62 = ScoringMatrix.from_name("BLOSUM62").int_data()
EDGE_LENGTHS = [0, 1, 63, 64, 65, 127, 128, 129]


def _inputs(queries, seqs, matrix=S):
    fp = ref_packing.pack_sequences_flat(seqs)
    flat = (fp.flat_targets, fp.lengths, fp.block_of_step,
            fp.chunk_of_step, fp.last_of_step)
    ref_args = [
        jnp.asarray(pr.make_profiles_host(queries, matrix), jnp.bfloat16),
        jnp.asarray([len(q) for q in queries], jnp.int32),
    ] + [jnp.asarray(a) for a in flat]
    port_args = [
        torch.from_numpy(ragged.make_profiles_host(queries, matrix)),
        torch.tensor([len(q) for q in queries], dtype=torch.int32),
    ] + [torch.from_numpy(a) for a in flat]
    return fp, ref_args, port_args


def _compare(ref_args, port_args, go, ge, algo, with_ends, chunk, **kw):
    ref = pr.search_flat(
        *ref_args, go, ge, algo, with_ends, interpret=True, chunk=chunk,
        safe_pad=True, **kw,
    )
    got = ragged.search_flat(*port_args, go, ge, algo, with_ends, chunk=chunk,
                             safe_pad=True)
    for r, g in zip(ref, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    return got


@pytest.mark.parametrize("with_ends", [False, True])
@pytest.mark.parametrize("algo", ["nw", "hw", "ov", "sw"])
def test_plain_matches_reference_tier64(algo, with_ends):
    rng = np.random.default_rng(11)
    lens = EDGE_LENGTHS + list(rng.integers(0, 150, 20))
    seqs = [rng.integers(0, 24, int(n)).astype(np.uint8) for n in lens]
    queries = [rng.integers(0, 24, n).astype(np.uint8) for n in (17, 40, 64)]
    fp, ref_args, port_args = _inputs(queries, seqs)
    go, ge = (3, 1) if with_ends else (1, 3)
    s, qe, te = _compare(ref_args, port_args, go, ge, algo, with_ends,
                         fp.chunk)
    assert s.shape == (3, fp.n_blocks, 128)
    if not with_ends:
        assert (qe == -1).all() and (te == -1).all()


@pytest.mark.parametrize("algo", ["nw", "hw", "ov", "sw"])
def test_plain_matches_reference_multi_strip(algo):
    """Two strips of 64 rows at the 128 tier (``strip=64``) with ties
    forced by zero gaps and low-complexity stretches."""
    rng = np.random.default_rng(91)
    lens = [0, 1, 5, 63, 64, 65, 130, 40, 97]
    seqs = [rng.integers(0, 24, n).astype(np.uint8) for n in lens]
    seqs.append(np.full(80, 2, np.uint8))
    seqs.append(np.tile(np.arange(4, dtype=np.uint8), 30))
    query = rng.integers(0, 24, 100).astype(np.uint8)
    query[30:60] = 2
    fp, ref_args, port_args = _inputs([query], seqs)
    assert ref_args[0].shape[1] == 128
    _compare(ref_args, port_args, 0, 0, algo, True, fp.chunk, strip=64)


def test_plain_matches_reference_huge_scores():
    """An identical pair under a +200 diagonal scores 60000: the pad
    rows and columns must still never win."""
    rng = np.random.default_rng(3)
    S_big = np.full((24, 24), -17, dtype=np.int32)
    np.fill_diagonal(S_big, 200)
    q = rng.integers(0, 24, 300).astype(np.uint8)
    seqs = [q.copy(), rng.integers(0, 24, 100).astype(np.uint8)]
    fp, ref_args, port_args = _inputs([q], seqs, S_big)
    s, _, _ = _compare(ref_args, port_args, 3, 1, "sw", True, fp.chunk)
    assert int(s.max()) == 60000


def test_wrapper_rejects_bad_inputs():
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 24, 30).astype(np.uint8)]
    q = [rng.integers(0, 24, 20).astype(np.uint8)]
    fp, _, port_args = _inputs(q, seqs)
    bad_dtype = list(port_args)
    bad_dtype[2] = bad_dtype[2].to(torch.int32)
    with pytest.raises(TypeError):
        ragged.search_flat(*bad_dtype, 3, 1, "sw", True, chunk=fp.chunk,
                           safe_pad=True)
    bad_prof = list(port_args)
    bad_prof[0] = bad_prof[0].float()
    with pytest.raises(TypeError):
        ragged.search_flat(*bad_prof, 3, 1, "sw", True, chunk=fp.chunk,
                           safe_pad=True)
    with pytest.raises(ValueError):
        ragged.search_flat(*port_args, 3, 1, "xx", True, chunk=fp.chunk,
                           safe_pad=True)
    assert not any(ragged.launches.values())  # CPU: no kernel launch


@pytest.mark.parametrize(
    "n_units, unit_rows, n_lanes, budget",
    [
        (3, 256, 384, 2 << 30),  # everything in one launch
        (200, 1024, 12288, 2 << 30),  # many queries: split over queries
        (8, 512, 1 << 20, 2 << 30),  # huge database: split over lanes
        (3, 256, 384, 8 * 256 * 128),  # one query, 128 lanes per launch
        (2, 64, 300, 1),  # budget below one unit x 128 lanes
        (0, 64, 384, 2 << 30),
    ],
)
def test_launch_plan_covers_every_pair_within_budget(
    n_units, unit_rows, n_lanes, budget
):
    units, lanes, chunks = ragged.launch_plan(
        n_units, unit_rows, n_lanes, budget
    )
    seen = np.zeros((n_units, n_lanes), np.int32)
    for u0, u1, n0, n1 in chunks:
        assert 0 < u1 - u0 <= units and 0 < n1 - n0 <= lanes
        seen[u0:u1, n0:n1] += 1
    assert (seen == 1).all()
    if chunks:
        assert units * lanes * unit_rows * 8 <= max(budget, unit_rows * 8 * 128)
        assert lanes == n_lanes or lanes % 128 == 0
    if n_units * unit_rows * n_lanes * 8 <= budget:
        assert len(chunks) <= 1


#: K1's packed route (``csrc/ragged_packed.cu``) as its kernel computes it:
#: (target lengths, query lengths, matrix, G and R of the emulation).  The
#: flat layout sorts lanes by length and the walk pairs lanes 2k, 2k + 1:
#: a few targets of spread lengths make pairs of unequal lengths and of a
#: zero-length lane, and an odd count leaves the longest target in a
#: lone final pair beside an empty padding lane.  "several passes" walks
#: 4-row passes (G = 2, R = 2) through the pair's buffer; "bound's edge"
#: is a tier-2048 query against targets of at most T_max = 31 residues
#: under BLOSUM62 x 93 (max |S| 1,023): the cap min(2048, 31) x 1,023 =
#: 31,713 is within 30 of the largest the walk holds, and a self-hit of
#: 31 W reaches it.
PAIR_CASES = {
    "unequal pairs": ([0, 0, 1, 3, 17, 40, 63, 64, 65, 90, 129],
                      [9, 40, 64], B62, [(None, 16), (4, 2)]),
    "several passes": ([0, 5, 17, 30, 41, 64, 77], [19, 33], B62,
                       [(2, 2)]),
    "bound's edge": ([0, 4, 9, 20, 30, 31, 31], [1100], B62 * 93,
                     [(None, 16)]),
}


def _pair_case(name):
    lens, qls, matrix, geometries = PAIR_CASES[name]
    rng = np.random.default_rng(61)
    seqs = [rng.integers(0, 20, n).astype(np.uint8) for n in lens]
    queries = [rng.integers(0, 20, n).astype(np.uint8) for n in qls]
    if name == "bound's edge":
        seqs[-1][:] = 17  # W: BLOSUM62's largest entry, 11, on itself
        queries[0][500:531] = 17
    else:  # a stretch of the longest target: scores well past the rest
        queries[-1][3:33] = seqs[-1][40:70]
    fp = ref_packing.pack_sequences_flat(seqs)
    args = [
        torch.from_numpy(ragged.make_profiles_host(queries, matrix)),
        torch.tensor(qls, dtype=torch.int32),
    ] + [torch.from_numpy(a) for a in (
        fp.flat_targets, fp.lengths, fp.block_of_step, fp.chunk_of_step,
        fp.last_of_step)]
    return fp, args, matrix, geometries


@pytest.mark.parametrize("name", sorted(PAIR_CASES))
def test_packed_pair_walk_equals_k1(name):
    """The pair form of the packed walk (lanes 2k, 2k + 1 in int16
    halves, each pair walked to its longer lane with the shorter one on
    pad columns, H capped at min(Q_pad, T_max) x max |S| where the
    engine's bound admits it, the tracker packed and unpacked) equals
    K1's plain int32 version on all three planes; the walk asserts every
    intermediate's int16 range for the cap."""
    fp, args, matrix, geometries = _pair_case(name)
    lens = fp.lengths.reshape(-1)
    q_pad = args[0].shape[1]
    t_max = int(lens.max())
    m_abs = int(np.abs(matrix).max())
    cap = min(q_pad, t_max) * m_abs
    assert engine._packed_exact_domain("sw", False, 12, 2, m_abs,
                                       min(q_pad, t_max))
    plain = ragged.search_flat_reference(*args, 12, 2, "sw", False, fp.chunk,
                                         True)
    for G, R in geometries:
        got = ragged.wave_reference(*args, 12, 2, "sw", False, fp.chunk, G=G,
                                    R=R, packed_cap=cap)
        for g, p in zip(got, plain):
            assert g.dtype == torch.int32
            assert torch.equal(g, p), (G, R)
    pairs = lens.reshape(-1, 2)
    if name == "unequal pairs":
        assert len(lens.nonzero()[0]) % 2 == 1  # the lone final pair
        assert ((pairs.min(1) == 0) & (pairs.max(1) > 0)).any()
        assert (pairs[:, 0] != pairs[:, 1]).sum() >= 4
    if name == "bound's edge":
        assert (q_pad, t_max, cap) == (2048, 31, 31713)
        assert int(plain[0].max()) == cap
        assert not ragged.packed_fits(12, 2, (t_max + 1) * m_abs)
    if name == "several passes":
        assert -(-max(PAIR_CASES[name][1]) // 4) > 2


def test_packed_route_on_the_cpu_is_k1s_plain_version():
    """`search_flat(packed_cap=...)` on CPU tensors runs K1's plain
    version, counted under ``ragged_packed``, and under a profiler counts
    K1's walks on the packed route."""
    from torch.profiler import ProfilerActivity, profile

    from pyopal_tpu_torch.utils import profiling

    fp, args, _, _ = _pair_case("unequal pairs")
    before = dict(ragged.plain_calls)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        got = ragged.search_flat(*args, 12, 2, "sw", False, chunk=fp.chunk,
                                 safe_pad=True, packed_cap=64 * 11)
        ragged.search_flat(*args, 12, 2, "sw", False, chunk=fp.chunk,
                           safe_pad=True)
    before["ragged_packed"] += 1
    before["ragged"] += 1
    assert ragged.plain_calls == before
    n = len(PAIR_CASES["unequal pairs"][1]) * fp.lengths.size
    assert {k: v for k, v in profiling.counters().items()
            if k.startswith("ragged.")} == {"ragged.walks_packed": n,
                                            "ragged.walks_wide": n}
    plain = ragged.search_flat_reference(*args, 12, 2, "sw", False, fp.chunk,
                                         True)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    assert (got[1] == -1).all() and (got[2] == -1).all()
    assert not any(ragged.launches.values())


@pytest.mark.parametrize("bad", [
    dict(algo="nw"),
    dict(with_ends=True),
    dict(safe_pad=False),  # a 32-column matrix: no pad symbol
    dict(gaps=(500, 13)),  # past the floor's reach
    dict(gaps=(-1, 2)),
    dict(cap=31744),  # past int16
])
def test_packed_route_rejects_what_the_walk_cannot_hold(bad):
    fp, args, _, _ = _pair_case("unequal pairs")
    with pytest.raises(ValueError):
        ragged.search_flat(
            *args, *bad.get("gaps", (12, 2)), bad.get("algo", "sw"),
            bad.get("with_ends", False), chunk=fp.chunk,
            safe_pad=bad.get("safe_pad", True),
            packed_cap=bad.get("cap", 704))
