"""The wavefront walk of K1-K7, emulated on the CPU, against `pyopal_tpu`.

The CUDA kernels of K1 (``csrc/ragged.cu``), K2 (``csrc/q8.cu``), K3
(``csrc/ragged_long.cu``), K4 (``csrc/ragged_v1.cu``), K5
(``csrc/ragged_strip.cu``), K6 (``csrc/group.cu``) and, in its packed
16-bit form, K7 (``csrc/q8_narrow.cu``) walk each (query, target) with a
group of G threads, R query rows each, in passes of G * R rows
(``csrc/wave.cuh``).  The kernels run only on the card; their CPU
emulations, `ragged.wave_reference`, `q8.wave_reference`,
`ragged_long.wave_segment_reference`, `ragged.wave_v1_reference`,
`ragged.wave_strip_reference`, `group.wave_group_reference` and
`q8.narrow_wave_reference`, mirror the passes, the per-thread row
blocks, the per-thread trackers and their merge.  Here they run at a small G and R (4 and 2: passes of 8 rows) so
that a short query crosses threads and passes, or at the kernels' own,
and must equal

- for K1, `pyopal_tpu.ops.pallas_ragged.search_flat` (interpreted,
  ``safe_pad=True``);
- for K2, `pyopal_tpu.ops.pallas_q8.search_flat_q8` (interpreted): the
  row-interleaved profiles of two groups, the second with empty slots;
- for K3, `pyopal_tpu.ops.pallas_ragged_long.search_flat_long` with
  ``QSEG`` lowered to 32 in both packages (segments of 4 passes), and
  segment by segment, with every output it hands on, the port's plain
  version `ragged_long.segment_reference`;
- for K5, the port's plain version `ragged.search_flat_strip_reference`
  at the 64 tier (pad rows past every query; gaps >= 0 walk rows
  [0, Q), a negative gap every row), and at the 512 tier, with the
  kernel's own G and R, `pallas_ragged.search_flat` (interpreted,
  ``safe_pad=False``);
- for K4, `pallas_ragged.search_flat` (interpreted, ``safe_pad=False``)
  at the 64 tier, where every query has pad rows (G = 4, R = 2; gaps
  >= 0 walk rows [0, Q) in both modes, -1/2 every row, ends included),
  and at the 512 tier with the kernel's own G = 16, R = 16 in end mode;
- for K6, `pyopal_tpu.ops.pallas_kernel.search_group` (interpreted) on
  ``tests/test_torch_group.py``'s group, with the kernel's own G and R,
  at queries whose ``Q_pad`` (a multiple of 8) is not a multiple of 16
  (20, 260), so that at -1/2 the masked final pass holds row ``Q - 1``,
  and at 13 (one of two threads without rows);
- for K7, `pallas_q8.search_flat_q8(..., narrow=True)` (interpreted) and
  the plain version `q8.search_flat_q8_reference(..., narrow=True)`, at
  gaps 3/1, 0/0 and 255/255, on paired slots of unequal lengths and
  empty slots, at the 64 tier (also at G = 4, R = 2), on the reference's
  narrow test at the 256 tier, and at the 512 tier (two passes);

with tolerance 0: all compute integer DP.  Query lengths sit on either
side of a pass (G * R - 1, G * R, G * R + 1, 2 * G * R + 3), targets at
the chunk edges (0, 1, 63, 64, 65, 129 residues), and a tie-heavy case
(a query and targets made of one repeated motif) puts equal maxima in
different threads, passes and columns.  The interpreted reference
kernels compile once per algorithm, mode and gap pair (~1 s for K1 at
``unroll=1``, ~3 s for K3), so each K1 case makes one reference call
with every query in it, and K3 calls the reference in the cases of
`K3_REF` only.  The file takes about five minutes in one process on
eight CPUs, and about as long on one of tier-1's six xdist workers
because `_torch_cpu` pins each worker's torch to its share of the CPUs:
unpinned, six workers' eight-thread OpenMP pools fight over the
emulations' thousands of tiny ops, and the file took 21 minutes.
"""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyopal_tpu.matrices import ScoringMatrix
from pyopal_tpu.ops import packing as ref_packing
from pyopal_tpu.ops import pallas_kernel as pk
from pyopal_tpu.ops import pallas_q8 as pq8
from pyopal_tpu.ops import pallas_ragged as pr
from pyopal_tpu.ops import pallas_ragged_long as prl
from pyopal_tpu_torch.ops import group, q8, ragged, ragged_long
import _torch_cpu  # noqa: F401  (torch threads: a worker's share)

S = ScoringMatrix.from_name("BLOSUM50").int_data()
ALGOS = ["nw", "hw", "ov", "sw"]
G, R = 4, 2
QLENS = [G * R - 1, G * R, G * R + 1, 2 * G * R + 3]
EDGE_LENGTHS = [0, 1, 63, 64, 65, 129]
#: BLOSUM50 codes of W, C, H, K, M, Y
MOTIF = np.array([17, 4, 8, 11, 12, 18], np.uint8)
GAPS = [(3, 1), (1, 3), (0, 0)]
#: (algorithm, with_ends, gaps): every algorithm and mode at gaps 3/1,
#: and every algorithm in end mode at 1/3 and 0/0
CASES = [(a, e, (3, 1)) for a, e in itertools.product(ALGOS, [False, True])]
CASES += [(a, True, g) for a, g in itertools.product(ALGOS, GAPS[1:])]


def _motif(n, phase=0):
    return np.resize(np.roll(MOTIF, phase), n).astype(np.uint8)


def _targets():
    """Random targets at the edge lengths and at seeded lengths, then
    repeated-motif targets at the edge lengths (random phases)."""
    rng = np.random.default_rng(31)
    lens = EDGE_LENGTHS + [int(n) for n in rng.integers(0, 90, 12)]
    seqs = [rng.integers(0, 20, n).astype(np.uint8) for n in lens]
    seqs += [_motif(n, int(rng.integers(0, 6))) for n in EDGE_LENGTHS[1:]]
    return seqs


def _queries():
    """Queries of `QLENS` residues, each holding 6 residues of the
    129-residue target, then a motif query of 2 * G * R + 3."""
    rng = np.random.default_rng(37)
    qs = [rng.integers(0, 20, n).astype(np.uint8) for n in QLENS]
    for q in qs:
        q[1:7] = _targets()[5][40:46]
    return qs + [_motif(QLENS[-1], 2)]


def _flat(fp):
    return (fp.flat_targets, fp.lengths, fp.block_of_step, fp.chunk_of_step,
            fp.last_of_step)


@functools.lru_cache(maxsize=None)
def _pack():
    return ref_packing.pack_sequences_flat(_targets())


def _assert_equal(got, ref, what):
    for k, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == torch.int32, what
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=f"{what} plane {k}")


@pytest.mark.parametrize("algo, with_ends, gaps", CASES)
def test_k1_wave_matches_reference(algo, with_ends, gaps):
    """K1's walk at G = 4, R = 2 equals the interpreted reference kernel
    on every lane; at gaps 3/1 also at G = 2, R = 4 and at the kernel's
    own G and R."""
    fp = _pack()
    qs = _queries()
    ref = pr.search_flat(
        jnp.asarray(pr.make_profiles_host(qs, S), jnp.bfloat16),
        jnp.asarray([len(q) for q in qs], jnp.int32),
        *(jnp.asarray(a) for a in _flat(fp)), *gaps, algo, with_ends,
        interpret=True, chunk=fp.chunk, safe_pad=True, unroll=1,
    )
    args = (
        torch.from_numpy(ragged.make_profiles_host(qs, S)),
        torch.tensor([len(q) for q in qs], dtype=torch.int32),
        *(torch.from_numpy(a) for a in _flat(fp)), *gaps, algo, with_ends,
        fp.chunk,
    )
    for g, r in ((G, R), (2, 4)) if gaps == (3, 1) else ((G, R),):
        _assert_equal(ragged.wave_reference(*args, G=g, R=r), ref,
                      f"G={g} R={r}")
    if gaps == (3, 1):  # the kernel's own: one pass of G = 4 x 16 rows
        assert ragged.wave_group(64) == 4
        _assert_equal(ragged.wave_reference(*args), ref, "kernel's G, R")


@pytest.fixture
def qseg32(monkeypatch):
    monkeypatch.setattr(prl, "QSEG", 32)
    monkeypatch.setattr(ragged_long, "QSEG", 32)


#: K3's cases: every algorithm and mode at gaps 3/1, sw and ov in end
#: mode at 1/3 and 0/0 (the trackers that rows and columns tie in)
K3_CASES = CASES[:8] + [(a, True, g) for a, g in
                        itertools.product(["sw", "ov"], GAPS[1:])]
#: those held against the reference too (end mode on the motif query,
#: score mode on the random one); the rest against the plain version
K3_REF = set(CASES[:8]) | {("sw", True, (0, 0)), ("ov", True, (0, 0))}


#: rows of the last segment of K3's queries: the `QLENS` beyond one pass,
#: so that it crosses a pass boundary and ends inside a thread
K3_TAILS = [n for n in QLENS if n > G * R]


def _k3_queries():
    """Queries of two full 32-row segments (a shared random prefix holding
    30 residues of the 129-residue target) and a last segment of each of
    `K3_TAILS` rows; then a motif query of 64 + 2 * G * R + 3 rows."""
    rng = np.random.default_rng(41)
    prefix = rng.integers(0, 20, 64).astype(np.uint8)
    prefix[20:50] = _targets()[5][50:80]
    qs = [np.concatenate([prefix, rng.integers(0, 20, n).astype(np.uint8)])
          for n in K3_TAILS]
    return qs + [_motif(64 + QLENS[-1], 1)]


@pytest.mark.parametrize("algo, with_ends, gaps", K3_CASES)
def test_k3_wave_matches_reference(qseg32, algo, with_ends, gaps):
    """K3's walk at G = 4, R = 2: each 32-row segment is 4 passes, the
    second starts at row 32.  Every segment of every query against the
    plain version, with the boundary rows and trackers it hands on (the
    random queries share their first two segments); the answer of an
    83-row query (the motif one in end mode, else the random one) against
    the reference where `K3_REF` says so."""
    fp = _pack()
    port_flat = [torch.from_numpy(a) for a in _flat(fp)]
    wave = functools.partial(ragged_long.wave_segment_reference, G=G, R=R)
    queries = _k3_queries()
    states = {}  # the state after the shared first two segments
    for k, q in enumerate(queries):
        n_seg = -(-len(q) // 32)
        prof = torch.from_numpy(
            ragged.make_profiles_host([q], S, q_pad=n_seg * 32)[0])
        hb = torch.zeros(fp.flat_targets.shape, dtype=torch.int32)
        fb = torch.full_like(hb, ragged_long.NEG)
        trk = torch.zeros((5, fp.n_blocks, 128), dtype=torch.int32)
        # the first two segments of the random queries are one walk
        # where the trackers start alike (nw and hw start from Q)
        shared = k < len(K3_TAILS) and algo in ("sw", "ov")
        for s in range(n_seg):
            if shared and s < 2 and s in states:
                hb, fb, trk = states[s]
                continue
            args = (prof[32 * s:32 * (s + 1)], len(q), 32 * s, *port_flat,
                    hb, fb, trk, *gaps, algo, with_ends, fp.chunk)
            want = ragged_long.segment_reference(*args)
            got = wave(*args)
            for name, g, w in zip(
                    ("scores", "q_ends", "t_ends", "hb", "fb", "trk"),
                    got, want):
                assert torch.equal(g, w), (len(q), s, name)
            hb, fb, trk = want[3:]
            if shared and s < 2:
                states[s] = (hb, fb, trk)
        if (algo, with_ends, gaps) in K3_REF and k == (
                len(queries) - 1 if with_ends else len(K3_TAILS) - 1):
            ref = prl.search_flat_long(
                q, S, *(jnp.asarray(a) for a in _flat(fp)), *gaps, algo,
                with_ends, interpret=True, chunk=fp.chunk,
            )
            _assert_equal(got[:3], ref, f"Q={len(q)}")


def test_wave_group_and_buffer():
    """The group size the kernels take per tier, and when K1 needs its
    pass buffer (tiers beyond one pass of 256 rows)."""
    assert [ragged.wave_group(n) for n in (1, 32, 33, 64, 65, 128, 256,
                                           257, 2048, 5120)] == [
        2, 2, 4, 4, 8, 8, 16, 16, 16, 16]
    assert ragged.wave_buffer_rows(256, 1000, 3) == 0
    assert ragged.wave_buffer_rows(512, 1000, 3) == 334


#: K2's queries: two groups of `q8.QB` slots, the second with 3 empty
#: slots; lengths at the walk's pass boundaries (7, 8, 9 at G * R = 8)
K2_QLENS = [19, 9, 8, 7, 16, 17, 15, 1, 9, 8, 7, 18, 2]


@pytest.mark.parametrize("with_ends", [False, True])
@pytest.mark.parametrize("algo", ALGOS)
def test_k2_wave_matches_reference(algo, with_ends):
    """K2's walk at G = 4, R = 2 over row-interleaved profiles equals the
    interpreted reference kernel on every (group, slot, lane), empty
    slots included, in the ``(n_groups, n_blocks, 8, lanes)`` layout."""
    rng = np.random.default_rng(43)
    qs = [rng.integers(0, 20, n).astype(np.uint8) for n in K2_QLENS]
    for q in qs[:3]:
        q[1:7] = _targets()[5][40:46]
    fp = ref_packing.pack_sequences_flat(_targets(), lanes=256)
    groups = q8.plan_groups(K2_QLENS)
    arrays = q8.make_profiles_q8_host(qs, S, groups, lanes=256)
    assert len(groups) == 2 and int((arrays[1][:, :, 0] == 0).sum()) == 3
    ref = pq8.search_flat_q8(
        jnp.asarray(arrays[0], jnp.bfloat16),
        *(jnp.asarray(a) for a in arrays[1:]),
        *(jnp.asarray(a) for a in _flat(fp)), 3, 1, algo, with_ends,
        interpret=True, chunk=fp.chunk, unroll=1, ncols=1,
    )
    got = q8.wave_reference(
        *(torch.from_numpy(a) for a in arrays),
        *(torch.from_numpy(a) for a in _flat(fp)), 3, 1, algo, with_ends,
        fp.chunk, G=G, R=R,
    )
    assert got[0].shape == (2, fp.n_blocks, q8.QB, 256)
    _assert_equal(got, ref, f"K2 {algo} ends={with_ends}")


#: K5's gaps: >= 0 (the walk stops at row Q - 1) and one negative gap
#: (every row walked, the pad rows counting for sw and ov)
K5_GAPS = GAPS + [(-1, 2)]


def _k5_args(qls, gaps, algo, q_pad=None):
    rng = np.random.default_rng(47)
    qs = [rng.integers(0, 20, n).astype(np.uint8) for n in qls]
    qs[0][1:7] = _targets()[5][40:46]
    fp = _pack()
    return (
        torch.from_numpy(ragged.make_profiles_host(qs, S, q_pad=q_pad)),
        torch.tensor(qls, dtype=torch.int32),
        *(torch.from_numpy(a) for a in _flat(fp)), *gaps, algo, fp.chunk,
    )


@pytest.mark.parametrize("gaps", K5_GAPS)
@pytest.mark.parametrize("algo", ALGOS)
def test_k5_wave_matches_plain(algo, gaps):
    """K5's walk at G = 4, R = 2 at the 64 tier (8 passes), queries
    ending before, on and after a pass boundary and inside a thread,
    equals its plain version; at the negative gap the walk over rows
    [0, Q) alone would not (sw and ov: the pad rows raise the score)."""
    args = _k5_args([60, 33, 8, 57], gaps, algo)
    got = ragged.wave_strip_reference(*args, G=G, R=R)
    want = ragged.search_flat_strip_reference(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if gaps == (-1, 2) and algo in ("sw", "ov"):
        k1_walk = ragged.wave_reference(*args[:-1], False, args[-1], G=G,
                                        R=R)
        assert not torch.equal(k1_walk[0], want[0])


@pytest.mark.parametrize("algo, gaps", [("sw", (-1, 2)), ("ov", (3, 1))])
def test_k5_wave_tier512_matches_reference(algo, gaps):
    """K5's walk with the kernel's own G = 16 and R = 16 at the 512 tier
    (two passes of 256 rows: row Q - 1 in the first for one query, in the
    second for the other) equals the interpreted reference kernel."""
    args = _k5_args([300, 100], gaps, algo)
    assert args[0].shape[1] == 512 and ragged.wave_group(512) == 16
    ref = pr.search_flat(
        jnp.asarray(args[0].numpy(), jnp.bfloat16),
        jnp.asarray(args[1].numpy()), *(jnp.asarray(a) for a in
                                       _flat(_pack())),
        *gaps, algo, False, interpret=True, chunk=args[-1], safe_pad=False,
        unroll=1,
    )
    _assert_equal(ragged.wave_strip_reference(*args), ref,
                  f"K5 {algo} gaps={gaps}")


#: K4's cases at the 64 tier: every algorithm and mode at 3/1 (rows
#: [0, Q) walked) and -1/2 (every row), and sw and ov, the algorithms
#: that read pad rows, in end mode at 0/0 (tie-heavy: the pad rows as
#: good as the rows above them)
K4_CASES = [(a, e, g) for g in [(3, 1), (-1, 2)] for a in ALGOS
            for e in (False, True)]
K4_CASES += [("sw", True, (0, 0)), ("ov", True, (0, 0))]


def _v1(qs, gaps, algo, with_ends):
    """K4's inputs over `_pack`, and the interpreted reference kernel's
    answer (``safe_pad=False``)."""
    fp = _pack()
    profs = ragged.make_profiles_host(qs, S)
    ref = pr.search_flat(
        jnp.asarray(profs, jnp.bfloat16),
        jnp.asarray([len(q) for q in qs], jnp.int32),
        *(jnp.asarray(a) for a in _flat(fp)), *gaps, algo, with_ends,
        interpret=True, chunk=fp.chunk, safe_pad=False, unroll=1,
    )
    args = (
        torch.from_numpy(profs), torch.tensor([len(q) for q in qs],
                                              dtype=torch.int32),
        *(torch.from_numpy(a) for a in _flat(fp)), *gaps, algo, with_ends,
        fp.chunk,
    )
    return args, ref


@pytest.mark.parametrize("algo, with_ends, gaps", K4_CASES)
def test_k4_wave_matches_reference(algo, with_ends, gaps):
    """K4's walk at G = 4, R = 2 at the 64 tier equals the interpreted
    reference kernel, which walks all 64 rows.  Every query of `_queries`
    ends before row 64 (7-19 residues, the motif one too): at gaps >= 0
    the walk stops at row Q - 1 in both modes and still gives the
    reference's ends (``csrc/ragged_v1.cu``'s proof), also at the
    kernel's own G = 4, R = 16; at -1/2 it walks every row (8 passes),
    and there the walk over rows [0, Q) alone would differ (sw and ov:
    the pad rows raise the score)."""
    args, ref = _v1(_queries(), gaps, algo, with_ends)
    _assert_equal(ragged.wave_v1_reference(*args, G=G, R=R), ref,
                  f"K4 G={G} R={R}")
    if gaps == (3, 1):
        assert ragged.wave_group(64) == 4
        _assert_equal(ragged.wave_v1_reference(*args), ref, "kernel's G, R")
    if gaps == (-1, 2) and algo in ("sw", "ov"):
        early = ragged.wave_v1_reference(*args, G=G, R=R, pad_rows=False)
        assert not np.array_equal(early[0].numpy(), np.asarray(ref[0]))


#: K4 at the 512 tier (end mode: score mode there is K5's), with the
#: kernel's own G = 16, R = 16: the pad-row walk with ends at -1/2 for
#: every algorithm, and rows [0, Q) at 3/1 and at 0/0
K4_512_CASES = [(a, (-1, 2)) for a in ALGOS] + [("sw", (3, 1)),
                                                 ("ov", (0, 0))]


@pytest.mark.parametrize("algo, gaps", K4_512_CASES)
def test_k4_wave_tier512_matches_reference(algo, gaps):
    """Two passes of 256 rows: a 300-residue query (row Q - 1 in the
    second pass) holding 6 residues of the 129-residue target and a
    100-residue motif query (in the first), every lane, end mode."""
    qs = [np.random.default_rng(53).integers(0, 20, 300).astype(np.uint8),
          _motif(100, 3)]
    qs[0][1:7] = _targets()[5][40:46]
    args, ref = _v1(qs, gaps, algo, True)
    assert args[0].shape[1] == 512 and ragged.wave_group(512) == 16
    _assert_equal(ragged.wave_v1_reference(*args), ref,
                  f"K4 tier 512 {algo} gaps={gaps}")


#: K6's cases (Q, algorithm, with_ends, gaps) on `_group`: Q = 20 (Q_pad
#: 24, G = 2: at -1/2 the one pass is masked and holds row Q - 1), 260
#: (Q_pad 264, G = 16: two passes, the second masked and holding row
#: Q - 1), 13 (Q_pad 16, G = 2: the second thread holds no row)
K6_CASES = (
    [(20, a, True, (-1, 2)) for a in ALGOS]
    + [(20, "sw", False, (-1, 2)), (20, "ov", False, (-1, 2)),
       (20, "sw", True, (3, 1)), (20, "hw", False, (3, 1))]
    + [(260, a, True, (-1, 2)) for a in ("sw", "ov", "hw")]
    + [(260, "nw", False, (-1, 2)), (260, "ov", True, (3, 1))]
    + [(13, "sw", True, (-1, 2)), (13, "ov", False, (-1, 2)),
       (13, "sw", True, (3, 1))]
)


def _k6(Q, prof_rows=None):
    """`_group` and a query of ``Q`` residues holding 10 of lane 7's,
    with its profile padded to ``prof_rows`` rows of ``PAD_SCORE``."""
    from test_torch_group import _group

    targets, lengths = _group(Q)
    q = np.random.default_rng(100 + Q).integers(0, 24, Q).astype(np.uint8)
    q[:10] = targets[0, 20:30, 7]
    prof = pk.make_profile_host(q, S)
    if prof_rows is not None:
        prof = np.pad(prof, ((0, prof_rows - prof.shape[0]), (0, 0)),
                      constant_values=ragged.PAD_SCORE)
    return prof, targets, lengths


def _k6_compare(Q, algo, with_ends, gaps, prof_rows=None):
    prof, targets, lengths = _k6(Q, prof_rows)
    ref = pk.search_group(
        (jnp.asarray(prof), Q), targets.astype(np.int32), lengths, *gaps,
        algo, with_ends=with_ends, interpret=True,
    )
    got = group.wave_group_reference(
        (torch.from_numpy(prof), Q), torch.from_numpy(targets),
        torch.from_numpy(lengths), *gaps, algo, with_ends,
    )
    _assert_equal(got, ref, f"K6 Q={Q} {algo} ends={with_ends} gaps={gaps}")


@pytest.mark.parametrize("Q, algo, with_ends, gaps", K6_CASES)
def test_k6_wave_matches_reference(Q, algo, with_ends, gaps):
    """K6's walk with the kernel's own G and R = 16 equals the
    interpreted reference kernel on every lane and plane, padding and
    zero-length lanes included."""
    q_pad = -(-Q // 8) * 8
    assert ragged.wave_group(q_pad) == (16 if Q > 32 else 2)
    _k6_compare(Q, algo, with_ends, gaps)


def test_k6_wave_qrow_before_masked_pass_matches_reference():
    """A 13-residue query with a 264-row profile at -1/2, sw with ends:
    row Q - 1 lies in the first pass, the masked final pass holds pad
    rows only."""
    _k6_compare(13, "sw", True, (-1, 2), prof_rows=264)


#: K7's cases: (query lengths, the group's query indices, a query that
#: is a stretch of a target, gaps, also at G = 4, R = 2).  A group's
#: slots pair up as (0, 1), (2, 3), ... in the order given, so that paired
#: slots differ in length (60/44, 9/50, 300/257) and an empty slot pairs
#: with a query or with another empty slot.  "self-hit" is the
#: reference's narrow test (`tests/test_q8.py`, seed 77: a 150-residue
#: query against itself, past the cap) at the 256 tier, one pass of 16
#: threads; "tier64" one pass of 4 threads (8 passes at G = 4, R = 2);
#: "tier512" two passes of the kernel's 16 threads through its buffer.
#: Targets of at most 64 residues keep the interpreted reference to one
#: grid step a group outside "self-hit".
K7_CASES = {
    "self-hit": (None, None, None, (3, 1), False),
    "tier64 0/0": ([60, 44, 9, 50, 17], [0, 1, 2, 3, 4], 0, (0, 0), True),
    "tier64 255/255": ([60, 44, 9, 50, 17], [0, 1, 2, 3, 4], 0, (255, 255),
                       False),
    "tier512": ([300, 257, 50, 9, 60, 61, 7], list(range(7)), 4, (3, 1),
                False),
}


@functools.lru_cache(maxsize=None)
def _k7_case(name):
    """K7's inputs for one case and the interpreted reference narrow pass
    on them (computed once per case)."""
    qls, group, stretch, gaps, _ = K7_CASES[name]
    if qls is None:  # the reference's narrow inputs, seed 77
        rng = np.random.default_rng(77)
        big = rng.integers(0, 20, 150).astype(np.uint8)
        seqs = [rng.integers(0, 20, int(n)).astype(np.uint8)
                for n in [0, 1, 40, 63, 64, 65, 90, 150, 17, 33]]
        seqs[7] = big.copy()
        qs = [rng.integers(0, 20, int(n)).astype(np.uint8)
              for n in (60, 44, 150, 21, 64, 15, 9, 50)]
        qs[2] = big.copy()
        groups = q8.plan_groups([len(q) for q in qs])
    else:
        rng = np.random.default_rng(53)
        seqs = [rng.integers(0, 20, n).astype(np.uint8)
                for n in (0, 1, 30, 63, 64, 20, 50)]
        qs = [rng.integers(0, 20, n).astype(np.uint8) for n in qls]
        qs[stretch] = seqs[4][: qls[stretch]].copy()  # scores past the cap
        groups = [group]
    fp = ref_packing.pack_sequences_flat(seqs, lanes=128)
    arrays = q8.make_profiles_q8_host(qs, S, groups, lanes=128)
    ref = pq8.search_flat_q8(
        jnp.asarray(arrays[0], jnp.bfloat16),
        *(jnp.asarray(a) for a in arrays[1:]),
        *(jnp.asarray(a) for a in _flat(fp)), *gaps, "sw", False,
        interpret=True, chunk=fp.chunk, narrow=True, unroll=1, ncols=8,
    )  # unroll and ncols: how it walks a chunk (the quickest here)
    args = [torch.from_numpy(a) for a in (*arrays, *_flat(fp))]
    return args, fp, [np.asarray(r) for r in ref]


@pytest.mark.parametrize("name", sorted(K7_CASES))
def test_k7_wave_matches_reference(name):
    """K7's packed walk (pairs of slots in int16 halves, the floor, the
    clamp, the cap folded into G, each pair walked to its longer slot,
    the tracker unpacked) at the kernel's own G and R, and in one case at
    G = 4, R = 2, equals the interpreted reference narrow pass and the
    plain version on all three planes; the walk asserts that every
    intermediate stays in its int16 range.  Scores are min(sw score,
    255), with some lane at the cap."""
    args, fp, ref = _k7_case(name)
    gaps, small = K7_CASES[name][3:]
    q_pad = args[0].shape[1] // q8.QB
    assert q_pad == {"self-hit": 256, "tier512": 512}.get(name, 64)
    plain = q8.search_flat_q8_reference(*args, *gaps, "sw", False, fp.chunk,
                                        True)
    _assert_equal(plain, ref, f"K7 plain {name}")
    for g, r in [(None, ragged.WAVE_R)] + [(G, R)] * small:
        got = q8.narrow_wave_reference(*args, *gaps, fp.chunk, G=g, R=r)
        _assert_equal(got, ref, f"K7 {name} G={g} R={r}")
    assert int((got[0] == q8.NARROW_CAP).sum()) >= 1
