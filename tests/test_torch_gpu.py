"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with its reason) where PyTorch sees
no CUDA device, as on CPU-only machines.  On a machine with the card::

    python -m pytest --noconftest -m cuda tests/test_torch_gpu.py

builds the kernels and holds each one against its plain PyTorch
version on the same inputs, with tolerance 0 (integer DP).
``--noconftest`` skips the suite's ``conftest.py``, which configures
JAX; the port's machine need not have JAX.
"""

import numpy as np
import pytest
import torch

from pyopal_tpu_torch.matrices import ScoringMatrix
from pyopal_tpu_torch.ops import (
    group, naive, packing, q8, ragged, ragged_long, traceback,
)
import _torch_cpu  # noqa: F401  (torch threads: a worker's share)

pytestmark = pytest.mark.cuda

S = ScoringMatrix.from_name("BLOSUM50").int_data()
LENGTHS = [0, 1, 63, 64, 65, 127, 128, 129, 300, 17]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _flat(fp, dev):
    return [
        torch.from_numpy(a).to(dev)
        for a in (fp.flat_targets, fp.lengths, fp.block_of_step,
                  fp.chunk_of_step, fp.last_of_step)
    ]


def _equal(kernel_out, plain_out):
    torch.cuda.synchronize()
    for k, p in zip(kernel_out, plain_out):
        assert k.shape == p.shape
        assert torch.equal(k, p)


@pytest.mark.parametrize("with_ends", [False, True])
@pytest.mark.parametrize("algo", ["nw", "hw", "ov", "sw"])
def test_ragged_kernel_matches_plain(dev, algo, with_ends):
    rng = np.random.default_rng(2)
    seqs = [rng.integers(0, 20, n).astype(np.uint8) for n in LENGTHS]
    queries = [rng.integers(0, 20, n).astype(np.uint8) for n in (200, 31)]
    fp = packing.pack_sequences_flat(seqs)
    args = (
        torch.from_numpy(ragged.make_profiles_host(queries, S)).to(dev),
        torch.tensor([200, 31], dtype=torch.int32, device=dev),
        *_flat(fp, dev), 3, 1, algo, with_ends, fp.chunk, True,
    )
    before = dict(ragged.launches)
    _equal(ragged.search_flat(*args), ragged.search_flat_reference(*args))
    before["ragged"] += 1
    assert ragged.launches == before


@pytest.mark.parametrize("with_ends", [False, True])
@pytest.mark.parametrize("algo", ["nw", "hw", "ov", "sw"])
def test_q8_kernel_matches_plain(dev, algo, with_ends):
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 20, n).astype(np.uint8) for n in LENGTHS]
    qls = [64, 1, 40, 63, 7, 50, 29, 33, 21, 3, 64, 12, 9, 17]
    queries = [rng.integers(0, 20, n).astype(np.uint8) for n in qls]
    fp = packing.pack_sequences_flat(seqs, lanes=512)
    groups = q8.plan_groups(qls)
    arrays = q8.make_profiles_q8_host(queries, S, groups, lanes=512)
    args = (
        *(torch.from_numpy(a).to(dev) for a in arrays),
        *_flat(fp, dev), 0, 2, algo, with_ends, fp.chunk,
    )
    before = dict(q8.launches)
    _equal(q8.search_flat_q8(*args), q8.search_flat_q8_reference(*args))
    before["q8"] += 1
    assert q8.launches == before


def _q8_args(dev, qls, algo, with_ends, seqs, queries=None, lanes=512):
    """K2 inputs: ``qls`` queries (random unless given) in q8 groups over
    ``seqs``."""
    rng = np.random.default_rng(4)
    if queries is None:
        queries = [rng.integers(0, 20, n).astype(np.uint8) for n in qls]
    fp = packing.pack_sequences_flat(seqs, lanes=lanes)
    groups = q8.plan_groups(qls)
    arrays = q8.make_profiles_q8_host(queries, S, groups, lanes=lanes)
    return (*(torch.from_numpy(a).to(dev) for a in arrays),
            *_flat(fp, dev), 3, 1, algo, with_ends, fp.chunk)


#: K2's query lengths by tier: around a thread's 16 rows and a pass (64,
#: 128, 256 rows at G = 4, 8, 16), and at 512 two passes; each a full
#: group and a short one (empty slots)
Q8_TIERS = {
    64: [16, 17, 63, 64, 1, 15, 33, 48, 7, 64, 2],
    128: [65, 127, 128, 100, 66, 80, 90, 120, 128],
    256: [255, 256, 129, 200, 240, 130, 160, 250, 256, 31],
    512: [512, 257, 300, 400, 511, 260, 333, 444, 100, 7],
}


@pytest.mark.parametrize("tie_heavy", [False, True])
@pytest.mark.parametrize("tier", sorted(Q8_TIERS))
def test_q8_kernel_tiers_match_plain(dev, tier, tie_heavy):
    """K2 at tiers 64 to 512 (one pass of G = 4, 8, 16 threads, then two
    passes through its buffer), every algorithm and mode, a short last
    group; on random targets, and on repeated-motif ones with motif
    queries (equal maxima in many columns and slots)."""
    rng = np.random.default_rng(tier)
    qls = Q8_TIERS[tier]
    if tie_heavy:
        seqs, motif = _motif_targets(rng, 300)
        queries = [np.resize(motif, n).astype(np.uint8) for n in qls]
    else:
        seqs = [rng.integers(0, 20, n).astype(np.uint8)
                for n in LENGTHS * 30]
        queries = None
    for algo in ("nw", "hw", "ov", "sw"):
        for with_ends in (False, True):
            args = _q8_args(dev, qls, algo, with_ends, seqs, queries)
            assert args[0].shape[1] == 8 * tier
            before = q8.launches["q8"]
            _equal(q8.search_flat_q8(*args),
                   q8.search_flat_q8_reference(*args))
            assert q8.launches["q8"] == before + 1


@pytest.mark.parametrize("split", ["lanes", "units"])
@pytest.mark.parametrize("kernel", ["ragged", "q8"])
def test_kernel_split_by_scratch_budget_matches_plain(
    dev, kernel, split, monkeypatch
):
    """A scratch budget too small for one launch splits the call into
    launches over query (group) and lane ranges; the result is the same.
    The per-launch bytes of K1 and K2 are their pass buffer (H and F per
    query, or per group slot, and target column), which a tier of several
    passes needs: K1 600 residues at the 1024 tier, four passes of 256
    rows; K2 two groups at the 512 tier, two passes."""
    rng = np.random.default_rng(5)
    seqs = [rng.integers(0, 20, n).astype(np.uint8) for n in LENGTHS * 30]
    if kernel == "ragged":
        qls = [600, 31, 90]
        queries = [rng.integers(0, 20, n).astype(np.uint8) for n in qls]
        fp = packing.pack_sequences_flat(seqs)
        args = (
            torch.from_numpy(ragged.make_profiles_host(queries, S)).to(dev),
            torch.tensor(qls, dtype=torch.int32, device=dev),
            *_flat(fp, dev), 3, 1, "sw", True, fp.chunk, True,
        )
        mod, fn, plain, n_units = ragged, ragged.search_flat, \
            ragged.search_flat_reference, len(qls)
        unit_rows = ragged.wave_buffer_rows(
            args[0].shape[1], fp.flat_targets.shape[0], fp.n_blocks)
        assert unit_rows > 0
    else:
        qls = Q8_TIERS[512]
        fp = packing.pack_sequences_flat(seqs, lanes=512)
        args = _q8_args(dev, qls, "sw", True, seqs)
        mod, fn, plain, n_units = q8, q8.search_flat_q8, \
            q8.search_flat_q8_reference, args[0].shape[0]
        unit_rows = q8.QB * ragged.wave_buffer_rows(
            512, fp.flat_targets.shape[0], fp.n_blocks)
        assert unit_rows > 0
    n_lanes = fp.lengths.size
    lanes_per_unit = 128 if split == "lanes" else n_lanes
    monkeypatch.setattr(ragged, "SCRATCH_BYTES", 8 * unit_rows * lanes_per_unit)
    want = n_units * (-(-n_lanes // lanes_per_unit))
    assert want > 1
    before = mod.launches[kernel]
    _equal(fn(*args), plain(*args))
    assert mod.launches[kernel] == before + want


def _segments_equal(q, fp, dev, algo, with_ends, qseg):
    """Every segment of query ``q``: K3 against its plain version on the
    same inputs (the kernel's state from the segment before), all six
    outputs.  Returns the kernel launches made."""
    flat = _flat(fp, dev)
    n_seg = -(-len(q) // qseg)
    prof = torch.from_numpy(
        ragged.make_profiles_host([q], S, q_pad=n_seg * qseg)[0]
    ).to(dev)
    hb = torch.zeros(flat[0].shape, dtype=torch.int32, device=dev)
    fb = torch.full_like(hb, ragged_long.NEG)
    trk = torch.zeros((5, fp.n_blocks, fp.lengths.shape[2]),
                      dtype=torch.int32, device=dev)
    before = ragged_long.launches
    for s in range(n_seg):
        args = (prof[s * qseg : (s + 1) * qseg], len(q), s * qseg, *flat,
                hb, fb, trk, 3, 1, algo, with_ends, fp.chunk)
        out = ragged_long.search_segment(*args)
        _equal(out, ragged_long.segment_reference(*args))
        hb, fb, trk = out[3:]
    return ragged_long.launches - before


@pytest.mark.parametrize("with_ends", [False, True])
@pytest.mark.parametrize("algo", ["nw", "hw", "ov", "sw"])
def test_ragged_long_kernel_matches_plain(dev, algo, with_ends):
    """K3 segment by segment at 32-row segments (2 to 4 per query),
    including the boundary rows and trackers it hands on."""
    rng = np.random.default_rng(6)
    seqs = [rng.integers(0, 20, n).astype(np.uint8) for n in LENGTHS]
    fp = packing.pack_sequences_flat(seqs)
    for Q in (33, 70, 100):
        q = rng.integers(0, 20, Q).astype(np.uint8)
        q[3:33] = seqs[8][100:130]  # a high-scoring stretch
        assert _segments_equal(q, fp, dev, algo, with_ends, 32) == -(-Q // 32)


def _motif_targets(rng, n):
    """``n`` targets of a repeated 6-residue motif (random phase, 3% of
    residues random) at the edge lengths: equal maxima in many columns."""
    motif = np.array([17, 4, 8, 11, 12, 18], np.uint8)
    out = []
    for L in (LENGTHS * n)[:n]:
        t = np.resize(np.roll(motif, int(rng.integers(0, 6))), L)
        hit = rng.random(L) < 0.03
        t[hit] = rng.integers(0, 20, int(hit.sum()))
        out.append(t.astype(np.uint8))
    return out, motif


@pytest.mark.parametrize("tie_heavy", [False, True])
@pytest.mark.parametrize("algo", ["nw", "hw", "ov", "sw"])
def test_ragged_long_multi_pass_segment_matches_plain(dev, algo, tie_heavy):
    """K3 at 2048-row segments: a 2,563-residue query is 8 passes of 256
    rows, then 3 passes whose last ends inside a thread's 16 rows; on
    random targets and on repeated-motif ones with a motif query."""
    rng = np.random.default_rng(8)
    if tie_heavy:
        seqs, motif = _motif_targets(rng, 300)
        q = np.resize(motif, 2563).astype(np.uint8)
    else:
        seqs = [rng.integers(0, 20, n).astype(np.uint8)
                for n in LENGTHS * 30]
        q = rng.integers(0, 20, 2563).astype(np.uint8)
        q[3:33] = seqs[8][100:130]
    fp = packing.pack_sequences_flat(seqs)
    for with_ends in (False, True):
        assert _segments_equal(q, fp, dev, algo, with_ends, 2048) == 2


@pytest.mark.parametrize("tie_heavy", [False, True])
@pytest.mark.parametrize("algo", ["nw", "hw", "ov", "sw"])
def test_ragged_kernel_pass_boundaries_match_plain(dev, algo, tie_heavy):
    """K1 at query lengths on either side of a thread's 16 rows and of a
    pass (64, 128 and 256 rows at G = 4, 8 and 16), through several
    passes, in both modes."""
    rng = np.random.default_rng(10)
    if tie_heavy:
        seqs, motif = _motif_targets(rng, 300)
    else:
        seqs = [rng.integers(0, 20, n).astype(np.uint8)
                for n in LENGTHS * 30]
    fp = packing.pack_sequences_flat(seqs)
    for qls in ([16, 17, 63, 64], [65, 127, 128], [255, 256, 257, 515]):
        if tie_heavy:
            queries = [np.resize(motif, n).astype(np.uint8) for n in qls]
        else:
            queries = [rng.integers(0, 20, n).astype(np.uint8) for n in qls]
        for with_ends in (False, True):
            args = (
                torch.from_numpy(ragged.make_profiles_host(queries, S)).to(
                    dev),
                torch.tensor(qls, dtype=torch.int32, device=dev),
                *_flat(fp, dev), 3, 1, algo, with_ends, fp.chunk, True,
            )
            _equal(ragged.search_flat(*args),
                   ragged.search_flat_reference(*args))


@pytest.mark.parametrize("algo", ["nw", "sw"])
def test_ragged_kernel_fine_tier_matches_plain(dev, algo):
    """K1 at the 4,608-row fine tier of one 4,200-residue query."""
    rng = np.random.default_rng(9)
    seqs = [rng.integers(0, 20, n).astype(np.uint8) for n in LENGTHS]
    q = rng.integers(0, 20, 4200).astype(np.uint8)
    fp = packing.pack_sequences_flat(seqs)
    profs = ragged.make_profiles_host([q], S, q_pad=ragged.fine_qpad(4200))
    assert profs.shape == (1, 4608, 32)
    args = (
        torch.from_numpy(profs).to(dev),
        torch.tensor([4200], dtype=torch.int32, device=dev),
        *_flat(fp, dev), 3, 1, algo, True, fp.chunk, True,
    )
    _equal(ragged.search_flat(*args), ragged.search_flat_reference(*args))


def _v1_args(dev, seed, qls, algo, with_ends, alphabet=20, matrix=S,
             go=3, ge=1, n_seqs=1):
    """K4/K5 inputs: ``qls`` queries (the first holding 30 residues of a
    target) over the edge lengths, ``n_seqs`` times over."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, alphabet, n).astype(np.uint8)
            for n in LENGTHS * n_seqs]
    queries = [rng.integers(0, alphabet, n).astype(np.uint8) for n in qls]
    queries[0][3:33] = seqs[8][100:130]
    fp = packing.pack_sequences_flat(seqs)
    return (
        torch.from_numpy(ragged.make_profiles_host(queries, matrix)).to(dev),
        torch.tensor(qls, dtype=torch.int32, device=dev),
        *_flat(fp, dev), go, ge, algo, with_ends, fp.chunk,
    )


@pytest.mark.parametrize("gaps", [(3, 1), (1, 3), (0, 0), (-1, 2)])
@pytest.mark.parametrize("with_ends", [False, True])
@pytest.mark.parametrize("algo", ["nw", "hw", "ov", "sw"])
def test_ragged_v1_kernel_matches_plain(dev, algo, with_ends, gaps):
    """K4 (no ``safe_pad``) at the 256 tier, every plane, pad rows
    included (a 31-residue query): rows [0, Q) at gaps >= 0, every row
    at -1/2, with ends too."""
    args = _v1_args(dev, 13, [200, 31], algo, with_ends, go=gaps[0],
                    ge=gaps[1])
    before = dict(ragged.launches)
    _equal(ragged.search_flat(*args), ragged.search_flat_reference(*args))
    before["ragged_v1"] += 1
    assert ragged.launches == before


@pytest.mark.parametrize("gaps", [(3, 1), (1, 3), (0, 0)])
@pytest.mark.parametrize("algo", ["nw", "hw", "ov", "sw"])
def test_ragged_strip_kernel_matches_plain(dev, algo, gaps):
    """K5 (score only, no ``safe_pad``) at the 1024 tier: four strips of
    256 rows, the queries' last rows in the second and fourth, and two
    of them pad-only."""
    args = _v1_args(dev, 14, [1000, 300], algo, False, go=gaps[0],
                    ge=gaps[1])
    before = dict(ragged.launches)
    out = ragged.search_flat(*args)
    _equal(out, ragged.search_flat_reference(*args))
    before["ragged_strip"] += 1
    assert ragged.launches == before
    assert (out[1] == -1).all() and (out[2] == -1).all()


#: K5's query lengths by tier: around a 256-row pass and at Q = Q_pad
STRIP_TIERS = {512: [512, 255, 256, 257], 1024: [1024, 255, 257, 770],
               4096: [4096, 2563, 256]}


@pytest.mark.parametrize("gaps", [(3, 1), (1, 3), (0, 0), (-1, 2)])
@pytest.mark.parametrize("tier", sorted(STRIP_TIERS))
def test_ragged_strip_kernel_pass_edges_match_plain(dev, tier, gaps):
    """K5 at tiers 512, 1024 and 4096, every algorithm, queries ending on
    either side of a pass and at the tier: with gaps >= 0 the walk stops
    at the pass that holds row Q - 1, with a negative gap it walks every
    row (the pad rows raise sw's and ov's score there)."""
    for algo in ("nw", "hw", "ov", "sw"):
        args = _v1_args(dev, 18, STRIP_TIERS[tier], algo, False,
                        go=gaps[0], ge=gaps[1], n_seqs=3)
        assert args[0].shape[1] == tier
        before = ragged.launches["ragged_strip"]
        out = ragged.search_flat(*args)
        _equal(out, ragged.search_flat_reference(*args))
        assert ragged.launches["ragged_strip"] == before + 1


@pytest.mark.parametrize("algo, with_ends, tier", [
    ("sw", True, 64), ("ov", False, 64), ("nw", True, 256),
    ("hw", False, 512), ("ov", False, 1024), ("sw", False, 4096),
])
def test_symbol_31_as_a_real_letter_matches_plain(dev, algo, with_ends, tier):
    """A random 32 x 32 matrix, targets and queries over all 32 symbols
    (symbol 31 too): K4 (tiers 64, 256) and K5 (512, 1024, and 4096 at a
    negative gap, which walks every row)."""
    rng = np.random.default_rng(31)
    m = rng.integers(-6, 7, (32, 32))
    m = ((m + m.T) // 2).astype(np.int32)
    qls = {64: [40, 60], 256: [200], 512: [300], 1024: [1000],
           4096: [2563]}[tier]
    go, ge = (-1, 2) if tier == 4096 else (3, 1)
    args = _v1_args(dev, 15, qls, algo, with_ends, alphabet=32, matrix=m,
                    go=go, ge=ge)
    _equal(ragged.search_flat(*args), ragged.search_flat_reference(*args))


@pytest.mark.parametrize("kernel", ["ragged_v1", "ragged_strip"])
def test_v1_kernels_split_by_scratch_budget_match_plain(dev, kernel,
                                                         monkeypatch):
    """A budget of one query and 128 lanes a launch splits K4 and K5
    calls over queries and lanes (at the 1024 tier, four passes, which
    need their pass buffer)."""
    ends = kernel == "ragged_v1"
    qls = [600, 31, 90] if ends else [600, 300]
    args = _v1_args(dev, 16, qls, "sw", ends, n_seqs=30)
    n_lanes = args[3].numel()
    rows = args[2].shape[0]
    # the pass buffer: H and F of the lane's columns
    unit_rows = ragged.wave_buffer_rows(args[0].shape[1], rows,
                                        args[3].shape[0])
    assert unit_rows > 0
    monkeypatch.setattr(ragged, "SCRATCH_BYTES", 8 * unit_rows * 128)
    before = ragged.launches[kernel]
    _equal(ragged.search_flat(*args), ragged.search_flat_reference(*args))
    want = len(qls) * -(-n_lanes // 128)
    assert want > len(qls) and ragged.launches[kernel] == before + want


#: K7's cases: query lengths and, where given, the groups' query indices
#: (slots pair up as (0, 1), (2, 3), ... in the order given): the 256 tier
#: (one pass, no buffer), 512 and 1024 (two and four passes through the
#: buffer), and "pairs", paired slots of unequal lengths (256/17, 9/200,
#: 255/1), an empty slot beside a query (129, 3) and pairs of empty slots
NARROW_CASES = {
    "tier256": ([256, 129, 200, 255, 140, 180, 222, 250, 64, 1, 40, 63, 7,
                 50, 29, 33], None),
    "tier512": ([512, 257, 300, 400, 511, 260, 333, 444, 100, 7], None),
    "tier1024": ([1024, 700, 513, 1000, 9, 600, 800, 250], None),
    "pairs": ([256, 17, 9, 200, 255, 1, 129, 64, 40, 3],
              [[0, 1, 2, 3, 4, 5, 6], [7, 8, 9]]),
}


def _narrow_args(dev, case="tier256", lanes=512):
    """K7's inputs for a case of `NARROW_CASES` over the edge lengths 30
    times, one query a 250-residue stretch of a target: its lane scores
    past 255."""
    rng = np.random.default_rng(17)
    seqs = [rng.integers(0, 20, n).astype(np.uint8) for n in LENGTHS * 30]
    qls, groups = NARROW_CASES[case]
    queries = [rng.integers(0, 20, n).astype(np.uint8) for n in qls]
    hit = next(i for i, n in enumerate(qls) if n >= 250)
    queries[hit][:250] = seqs[8][:250]
    fp = packing.pack_sequences_flat(seqs, lanes=lanes)
    groups = q8.plan_groups(qls) if groups is None else groups
    arrays = q8.make_profiles_q8_host(queries, S, groups, lanes=lanes)
    return (*(torch.from_numpy(a).to(dev) for a in arrays), *_flat(fp, dev))


@pytest.mark.parametrize("gaps", [(3, 1), (0, 0), (255, 255)])
@pytest.mark.parametrize("case", sorted(NARROW_CASES))
def test_q8_narrow_kernel_matches_plain(dev, case, gaps):
    """K7 against its plain version, and its scores min(K2's, 255) on the
    same tensors, with at least one lane flagged; one launch."""
    args = _narrow_args(dev, case)
    before = dict(q8.launches)
    out = q8.search_flat_q8(*args, *gaps, "sw", False, narrow=True)
    _equal(out, q8.search_flat_q8_reference(*args, *gaps, "sw", False,
                                            narrow=True))
    before["q8_narrow"] += 1
    assert q8.launches == before
    exact = q8.search_flat_q8(*args, *gaps, "sw", False)
    _equal(out[:1], [exact[0].clamp(max=q8.NARROW_CAP)])
    assert int((out[0] == q8.NARROW_CAP).sum()) >= 1


def test_q8_narrow_split_by_scratch_budget_matches_plain(dev, monkeypatch):
    """A budget of one group and 128 lanes a launch for K7's pass buffer
    (packed G and F per pair of slots and target column) at the 512 tier,
    two passes."""
    args = _narrow_args(dev, "tier512")
    assert args[0].shape[1] == 8 * 512
    unit_rows = q8.QB // 2 * ragged.wave_buffer_rows(
        512, args[3].shape[0], args[4].shape[0])
    assert unit_rows > 0
    monkeypatch.setattr(ragged, "SCRATCH_BYTES", 8 * unit_rows * 128)
    before = q8.launches["q8_narrow"]
    _equal(q8.search_flat_q8(*args, 3, 1, "sw", False, narrow=True),
           q8.search_flat_q8_reference(*args, 3, 1, "sw", False,
                                       narrow=True))
    want = args[0].shape[0] * -(-args[4].numel() // 128)
    assert want > 2 and q8.launches["q8_narrow"] == before + want


@pytest.mark.parametrize("tie_heavy", [False, True])
@pytest.mark.parametrize("tier", sorted(Q8_TIERS))
def test_q8_packed_route_equals_k2(dev, tier, tie_heavy):
    """K2's exact route on the packed walk (H's cap at Q_pad x max |S|,
    as the engine launches it) against K2's int32 walk and the plain
    version, bit for bit, at tiers 64 to 512 (one pass of G = 4, 8, 16
    threads, then two passes through the pair's buffer), a short last
    group (an empty slot in a pair, a pair of empty slots), random and
    repeated-motif targets; one launch each."""
    rng = np.random.default_rng(tier)
    qls = Q8_TIERS[tier]
    if tie_heavy:
        seqs, motif = _motif_targets(rng, 300)
        queries = [np.resize(motif, n).astype(np.uint8) for n in qls]
    else:
        seqs = [rng.integers(0, 20, n).astype(np.uint8)
                for n in LENGTHS * 30]
        queries = None
    args = _q8_args(dev, qls, "sw", False, seqs, queries)
    cap = tier * int(np.abs(S).max())
    before = dict(q8.launches)
    out = q8.search_flat_q8(*args, packed_cap=cap)
    _equal(out, q8.search_flat_q8(*args))
    _equal(out, q8.search_flat_q8_reference(*args))
    before["q8"] += 1
    before["q8_packed"] += 1
    assert q8.launches == before


@pytest.mark.parametrize("tier, scale", [(64, 33), (256, 8), (512, 4)])
def test_q8_packed_route_at_the_largest_admitted_cap(dev, tier, scale):
    """BLOSUM50 scaled so that Q_pad x max |S| is the largest cap the
    engine admits at the tier (31,680 at 64 rows, 30,720 at 256 and
    512), with queries that are stretches of targets (scores in the
    thousands): the packed walk equals K2's int32 walk."""
    from pyopal_tpu_torch.ops import engine

    big = S * scale
    m_abs = int(np.abs(big).max())
    assert engine._packed_exact_domain("sw", False, 3, 1, m_abs, tier)
    rng = np.random.default_rng(scale)
    seqs = [rng.integers(0, 20, n).astype(np.uint8) for n in LENGTHS * 30]
    seqs[8] = rng.integers(0, 20, 600).astype(np.uint8)
    qls = [tier - k for k in range(10)]
    queries = [seqs[8][:n].copy() for n in qls]
    fp = packing.pack_sequences_flat(seqs, lanes=512)
    groups = q8.plan_groups(qls)
    arrays = q8.make_profiles_q8_host(queries, big, groups, lanes=512)
    args = (*(torch.from_numpy(a).to(dev) for a in arrays),
            *_flat(fp, dev), 3, 1, "sw", False, fp.chunk)
    out = q8.search_flat_q8(*args, packed_cap=tier * m_abs)
    _equal(out, q8.search_flat_q8(*args))
    assert int(out[0].max()) > 300 * scale


def test_q8_packed_split_by_scratch_budget_matches_k2(dev, monkeypatch):
    """A budget of one group and 128 lanes a launch for the packed walk's
    pass buffer at the 512 tier: the launches it makes, and K2's
    scores."""
    rng = np.random.default_rng(5)
    seqs = [rng.integers(0, 20, n).astype(np.uint8) for n in LENGTHS * 30]
    args = _q8_args(dev, Q8_TIERS[512], "sw", False, seqs)
    unit_rows = q8.QB // 2 * ragged.wave_buffer_rows(
        512, args[3].shape[0], args[4].shape[0])
    assert unit_rows > 0
    want = q8.search_flat_q8(*args)
    monkeypatch.setattr(ragged, "SCRATCH_BYTES", 8 * unit_rows * 128)
    before = q8.launches["q8_packed"]
    _equal(q8.search_flat_q8(*args, packed_cap=512 * 15), want)
    n = args[0].shape[0] * -(-args[4].numel() // 128)
    assert n > 2 and q8.launches["q8_packed"] == before + n


@pytest.mark.parametrize("mode", ["score", "end"])
def test_engine_routes_q8_groups_by_mode(dev, mode):
    """Through `Aligner.align_arrays` on the card (BLOSUM50 3/1): 14
    queries of the 256 tier are two q8 groups, one launch on the packed
    walk in sw score mode and on K2's int32 walk in end mode, with the
    same scores; nw takes K2 in either mode."""
    import pyopal_tpu_torch as pt

    rng = np.random.default_rng(14)
    letters = "ARNDCQEGHILKMFPSTWYV"
    db = pt.Database(["".join(rng.choice(list(letters), int(n)))
                      for n in rng.integers(1, 400, 500)])
    queries = ["".join(rng.choice(list(letters), int(n)))
               for n in rng.integers(129, 257, 14)]
    al = pt.Aligner(device="cuda")
    before = dict(q8.launches)
    got = al.align_arrays(queries, db, mode=mode)
    route = "q8_packed" if mode == "score" else "q8"
    before[route] += 1
    assert q8.launches == before
    other = al.align_arrays(queries, db, mode="end" if mode == "score"
                            else "score")
    np.testing.assert_array_equal(got["scores"], other["scores"])
    before = dict(q8.launches)
    al.align_arrays(queries, db, mode=mode, algorithm="nw")
    before["q8"] += 1
    assert q8.launches == before


B62 = ScoringMatrix.from_name("BLOSUM62").int_data()
#: K1's packed route, by tier: its query lengths alone and as a cohort
#: (a fine tier takes one query), at BLOSUM62 12/2, whose largest entry
#: holds T_max 2,885 in int16 at tiers past 2048
PACKED_K1_TIERS = {
    64: [64, 33, 1], 128: [128, 65, 90], 256: [256, 129, 200],
    512: [512, 257, 300], 1024: [1024, 515, 700],
    2048: [2048, 1025, 1500], 4096: [4096, 2049, 3000], 5120: [5000],
}


def _packed_k1_targets(rng):
    """Random targets at the edge lengths, 301 of them (an odd count: a
    lone final pair), and one of exactly T_max = 2,885 residues."""
    seqs = [rng.integers(0, 20, n).astype(np.uint8) for n in LENGTHS * 30]
    seqs.append(rng.integers(0, 20, 2885).astype(np.uint8))
    return seqs


@pytest.mark.parametrize("cohort", [False, True])
@pytest.mark.parametrize("tier", sorted(PACKED_K1_TIERS))
def test_ragged_packed_route_equals_k1(dev, tier, cohort):
    """K1's packed route (two lanes a walk, H capped at min(Q_pad, T_max)
    x 11, the engine's bound) against K1's int32 walk, bit for bit, at
    tiers 64 to 4096 and the 5,120-row fine tier, one query and a cohort,
    queries holding a stretch of the 2,885-residue target; one launch
    each."""
    from pyopal_tpu_torch.ops import engine

    rng = np.random.default_rng(tier)
    seqs = _packed_k1_targets(rng)
    qls = PACKED_K1_TIERS[tier] if cohort else PACKED_K1_TIERS[tier][:1]
    if cohort and len(qls) == 1:
        pytest.skip("a fine tier holds one query")
    queries = [rng.integers(0, 20, n).astype(np.uint8) for n in qls]
    for q in queries:
        k = min(len(q), 1500)
        q[:k] = seqs[-1][:k]
    fp = packing.pack_sequences_flat(seqs)
    profs = ragged.make_profiles_host(
        queries, B62, q_pad=tier if tier == 5120 else None)
    assert profs.shape[1] == tier
    cap = min(tier, 2885) * 11
    assert engine._packed_exact_domain("sw", False, 12, 2, 11,
                                       min(tier, 2885))
    args = (torch.from_numpy(profs).to(dev),
            torch.tensor(qls, dtype=torch.int32, device=dev),
            *_flat(fp, dev), 12, 2, "sw", False, fp.chunk, True)
    before = dict(ragged.launches)
    out = ragged.search_flat(*args, packed_cap=cap)
    want = ragged.search_flat(*args)
    _equal(out, want)
    before["ragged"] += 1
    before["ragged_packed"] += 1
    assert ragged.launches == before
    assert int(out[0].max()) > 4 * min(max(qls), 1500)


def test_ragged_packed_route_at_the_bound_edge(dev):
    """BLOSUM62 x 93 (max |S| 1,023) with targets of at most 31 residues:
    a tier-2048 query's cap, 31 x 1,023 = 31,713, is within 30 of the
    largest the walk holds, and a self-hit of 31 W reaches it."""
    from pyopal_tpu_torch.ops import engine

    rng = np.random.default_rng(31)
    big = B62 * 93
    seqs = [rng.integers(0, 20, n).astype(np.uint8)
            for n in list(rng.integers(0, 32, 400)) + [31]]
    seqs[-1][:] = 17
    q = rng.integers(0, 20, 1100).astype(np.uint8)
    q[500:531] = 17
    fp = packing.pack_sequences_flat(seqs)
    cap = 31 * 1023
    assert engine._packed_exact_domain("sw", False, 12, 2, 1023, 31)
    assert not engine._packed_exact_domain("sw", False, 12, 2, 1023, 32)
    args = (torch.from_numpy(ragged.make_profiles_host([q], big)).to(dev),
            torch.tensor([1100], dtype=torch.int32, device=dev),
            *_flat(fp, dev), 12, 2, "sw", False, fp.chunk, True)
    out = ragged.search_flat(*args, packed_cap=cap)
    _equal(out, ragged.search_flat(*args))
    assert int(out[0].max()) == cap


def test_ragged_packed_split_by_scratch_budget_matches_k1(dev, monkeypatch):
    """A budget of one query and 128 lanes a launch for the packed
    route's pass buffer at the 1024 tier (four passes): the launches it
    makes, and K1's scores; the buffer holds half of K1's bytes a lane."""
    rng = np.random.default_rng(7)
    seqs = _packed_k1_targets(rng)
    qls = PACKED_K1_TIERS[1024]
    queries = [rng.integers(0, 20, n).astype(np.uint8) for n in qls]
    fp = packing.pack_sequences_flat(seqs)
    args = (torch.from_numpy(ragged.make_profiles_host(queries, B62)).to(dev),
            torch.tensor(qls, dtype=torch.int32, device=dev),
            *_flat(fp, dev), 12, 2, "sw", False, fp.chunk, True)
    want = ragged.search_flat(*args)
    unit_rows = ragged.wave_buffer_rows(1024, fp.flat_targets.shape[0],
                                        fp.n_blocks)
    assert unit_rows > 0
    monkeypatch.setattr(ragged, "SCRATCH_BYTES", 4 * unit_rows * 128)
    _, buf = ragged.wave_buffer(len(qls), 1, 1024, args[2], fp.n_blocks,
                                pairs=True)
    assert buf.shape == (1, 1, 2, fp.flat_targets.shape[0], 64)
    before = ragged.launches["ragged_packed"]
    _equal(ragged.search_flat(*args, packed_cap=1024 * 11), want)
    n = len(qls) * -(-fp.lengths.size // 128)
    assert n > 3 and ragged.launches["ragged_packed"] == before + n


@pytest.mark.parametrize("mode", ["score", "end"])
def test_engine_routes_k1_by_mode(dev, mode, monkeypatch):
    """Through `Aligner.align_arrays` on the card (BLOSUM62 12/2; the
    route's floor of blocks lowered to one for a small database): a K1
    cohort at the 512 tier and a 5,000-residue query at its fine tier
    take K1's packed route in sw score mode, K1's int32 walk in end mode,
    with the same scores; a profiler counts K1's walks by route."""
    from torch.profiler import ProfilerActivity, profile

    import pyopal_tpu_torch as pt
    from pyopal_tpu_torch.ops import engine
    from pyopal_tpu_torch.utils import profiling

    monkeypatch.setattr(engine, "_PACKED_MIN_BLOCKS", 1)

    rng = np.random.default_rng(15)
    letters = "ARNDCQEGHILKMFPSTWYV"
    db = pt.Database(["".join(rng.choice(list(letters), int(n)))
                      for n in rng.integers(1, 2000, 700)])
    queries = ["".join(rng.choice(list(letters), int(n)))
               for n in (5000, 300, 400, 500)]
    al = pt.Aligner("BLOSUM62", gap_open=12, gap_extend=2, device="cuda")
    before = dict(ragged.launches)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        got = al.align_arrays(queries, db, mode=mode)
    k1 = "ragged_packed" if mode == "score" else "ragged"
    before[k1] += 2
    assert ragged.launches == before
    walks = {k: v for k, v in profiling.counters().items()
             if k.startswith("ragged.")}
    lanes = -(-len(db) // 128) * 128
    assert walks == {("ragged.walks_packed" if mode == "score"
                      else "ragged.walks_wide"): 4 * lanes}
    other = al.align_arrays(queries, db, mode="end" if mode == "score"
                            else "score")
    np.testing.assert_array_equal(got["scores"], other["scores"])


def _group_args(dev, seed, n_blocks=2, Q=13):
    """A K6 group: blocks of 128 lanes at t_pad 512 with the edge lengths
    and zero-length lanes, and a query of ``Q`` residues (13: 3 pad
    rows)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 301, (n_blocks, 128)).astype(np.int32)
    lengths[0, :9] = [0, 1, 31, 32, 33, 255, 256, 257, 300]
    lengths[-1, -3:] = 0
    targets = rng.integers(0, 24, (n_blocks, 512, 128)).astype(np.uint8)
    q = rng.integers(0, 24, Q).astype(np.uint8)
    q[:10] = targets[0, 20:30, 7]
    return (group.make_profile(q, S, dev), torch.from_numpy(targets).to(dev),
            torch.from_numpy(lengths).to(dev))


@pytest.mark.parametrize("gaps", [(3, 1), (-1, 2)])
@pytest.mark.parametrize("with_ends", [False, True])
@pytest.mark.parametrize("algo", ["nw", "hw", "ov", "sw"])
def test_group_kernel_matches_plain(dev, algo, with_ends, gaps):
    """K6 on every lane and plane, padding lanes included, at queries of
    13 (one thread of rows idle), 20 and 260 residues (Q_pad 24 and 264,
    not multiples of 16: at -1/2 the masked final pass holds row Q - 1;
    260: two passes)."""
    for Q in (13, 20, 260):
        prof, targets, lengths = _group_args(dev, 10, Q=Q)
        args = (prof, targets, lengths, *gaps, algo, with_ends)
        before = group.launches
        _equal(group.search_group(*args),
               group.search_group_reference(*args))
        assert group.launches == before + 1


def test_group_kernel_split_by_scratch_budget_matches_plain(dev, monkeypatch):
    """A 300-residue query (two passes, which need the pass buffer) and a
    budget of one block's buffer (512 columns x 128 lanes) make one
    launch per block."""
    prof, targets, lengths = _group_args(dev, 11, n_blocks=3, Q=300)
    monkeypatch.setattr(ragged, "SCRATCH_BYTES", 8 * 512 * 128)
    args = (prof, targets.to(torch.int32), lengths, 1, 3, "sw", True)
    before = group.launches
    _equal(group.search_group(*args), group.search_group_reference(*args))
    assert group.launches == before + 3


def test_sharded_search_on_two_cuda_shards_matches_aligner(dev):
    """`align_arrays_sharded` over 2 shards on the card (K2 and K1 once
    per shard) against `Aligner.align_arrays` on the card."""
    import pyopal_tpu_torch as pt
    from pyopal_tpu_torch.parallel import align_arrays_sharded, device_mesh

    rng = np.random.default_rng(12)
    letters = "ARNDCQEGHILKMFPSTWYV"
    seqs = ["".join(letters[c] for c in rng.integers(0, 20, n))
            for n in rng.integers(0, 400, 700)]
    queries = ["".join(letters[c] for c in rng.integers(0, 20, n))
               for n in [50] * 9 + [0, 200]]
    db = pt.Database(seqs)
    mesh = device_mesh(2)
    assert mesh.n_shards == 2 and mesh.platform == "cuda"
    for mode in ("score", "end"):
        before = (ragged.launches["ragged"], q8.launches["q8"])
        got = align_arrays_sharded(queries, db, mode=mode, mesh=mesh)
        assert (ragged.launches["ragged"], q8.launches["q8"]) == (
            before[0] + 2 * 2, before[1] + 2)
        want = pt.Aligner(device=dev).align_arrays(queries, db, mode=mode)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _tb_batch(dev, seed, Q=70, n_real=13, B=16, T_pad=256):
    """A traceback batch as the engine builds one: B a power of two with
    ``B - n_real`` padding pairs (length 0), T_pad a multiple of 128, a
    query of several 32-row strips."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 20, Q).astype(np.uint8)
    lens = np.zeros(B, np.int32)
    lens[:n_real] = rng.integers(1, T_pad + 1, n_real)
    lens[:3] = [T_pad, 1, 127]
    tgt = np.zeros((B, T_pad), np.int32)
    for b in range(n_real):
        tgt[b, : lens[b]] = rng.integers(0, 20, lens[b])
    tgt[0, 9:39] = q[:30]
    prof = np.ascontiguousarray(np.asarray(S, np.int32)[q.astype(np.int64)])
    return (q, tgt, lens, torch.from_numpy(prof).to(dev),
            torch.from_numpy(tgt).to(dev), torch.from_numpy(lens).to(dev))


@pytest.mark.parametrize("gaps", [(3, 1), (1, 3)])
@pytest.mark.parametrize("algo", ["nw", "hw", "ov", "sw"])
def test_traceback_dirs_kernel_matches_plain(dev, algo, gaps):
    """T1 against its plain version, byte for byte: at the pairs' lengths
    (columns past each length zero, padding pairs included) and at every
    column."""
    _, _, _, prof, tgt, lens = _tb_batch(dev, 40)
    before = traceback.launches["traceback_dirs"]
    for n in (lens, torch.full_like(lens, tgt.shape[1])):
        got = traceback._dir_matrix_batch(prof, tgt, *gaps, algo, n)
        want = traceback.dir_matrix_reference(prof, tgt, *gaps, algo, n)
        _equal([got], [want])
    assert traceback.launches["traceback_dirs"] == before + 2


@pytest.mark.parametrize("gaps", [(3, 1), (1, 3)])
@pytest.mark.parametrize("algo", ["nw", "hw", "ov", "sw"])
def test_traceback_walk_kernel_matches_plain(dev, algo, gaps):
    """T2 against its plain version on the plain direction bytes:
    ``buf``, ``i``, ``j``; the oracle's ends, an end on column 0
    (``te == -1``) for hw/ov, and (-1, -1) for padding pairs and sw's
    empty alignments."""
    q, tgt, lens, prof, tgt_d, lens_d = _tb_batch(dev, 41)
    dirs = traceback.dir_matrix_reference(prof, tgt_d, *gaps, algo, lens_d)
    qes = np.full(len(lens), -1, np.int32)
    tes = np.full(len(lens), -1, np.int32)
    for b, n in enumerate(lens):
        if n:
            _, qe, te = naive.score_end(q, tgt[b, :n], S, *gaps, algo)
            if algo != "sw" or (qe >= 0 and te >= 0):
                qes[b], tes[b] = qe, te
    if algo in ("hw", "ov"):
        qes[5], tes[5] = len(q) - 1, -1
    if algo == "sw":
        qes[6], tes[6] = -1, -1
    args = (dirs, torch.from_numpy(qes).to(dev),
            torch.from_numpy(tes).to(dev), algo)
    before = traceback.launches["traceback_walk"]
    _equal(traceback._walk_batch_device(*args),
           traceback.walk_reference(*args))
    assert traceback.launches["traceback_walk"] == before + 1


@pytest.mark.parametrize("Q", [1, 15, 16, 17, 255, 256, 257, 511, 512, 513])
def test_traceback_kernels_at_walk_edges(dev, Q):
    """T1 and T2 against their plain versions where the new walks change
    hands: queries on either side of a thread's 8 rows, of T1's 256-row
    pass and of two passes; targets on either side of T2's 64-column
    tile and of T1's symbol tiles, padding pairs; every algorithm at 3/1
    and sw at -1/2.  T2 walks T1's own buffer (its layout as it is) and
    the plain bytes (copied into it), from each pair's terminal cell or a
    random one."""
    rng = np.random.default_rng(Q)
    q = rng.integers(0, 20, Q).astype(np.uint8)
    lens = np.array([0, 1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 0],
                    np.int32)
    T_pad = 256
    tgt = np.zeros((16, T_pad), np.int32)
    for b, n in enumerate(lens):
        tgt[b, :n] = rng.integers(0, 20, n)
    tgt[8, 3:3 + min(Q, 120)] = q[:120]
    lens = np.concatenate([lens, [T_pad, 200, 0, 0]]).astype(np.int32)
    tgt[12, :T_pad] = np.resize(q, T_pad)
    tgt[13, :200] = rng.integers(0, 20, 200)
    prof = torch.from_numpy(np.ascontiguousarray(
        np.asarray(S, np.int32)[q.astype(np.int64)])).to(dev)
    tgt_d = torch.from_numpy(tgt).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    for algo, gaps in [(a, (3, 1)) for a in ("nw", "hw", "ov", "sw")] + [
            ("sw", (-1, 2))]:
        got = traceback._dir_matrix_batch(prof, tgt_d, *gaps, algo, lens_d)
        want = traceback.dir_matrix_reference(prof, tgt_d, *gaps, algo,
                                              lens_d)
        _equal([got], [want])
        # ends: the terminal cell, a random cell, (-1, -1) for padding
        qes = np.where(lens > 0, Q - 1, -1).astype(np.int32)
        tes = (lens - 1).astype(np.int32)
        some = (np.arange(len(lens)) % 2 == 1) & (lens > 0)
        qes[some] = rng.integers(0, Q, int(some.sum()))
        tes[some] = rng.integers(0, lens[some])
        ends = (torch.from_numpy(qes).to(dev), torch.from_numpy(tes).to(dev),
                algo)
        plain = traceback.walk_reference(want, *ends)
        _equal(traceback._walk_batch_device(got, *ends), plain)
        _equal(traceback._walk_batch_device(want, *ends), plain)


def test_full_mode_on_the_card_matches_cpu(dev):
    """``align(mode="full")`` and ``align_top_k`` on the card (K1, T1,
    T2) against the CPU port (the plain versions), every algorithm."""
    import pyopal_tpu_torch as pt

    rng = np.random.default_rng(13)
    letters = "ARNDCQEGHILKMFPSTWYV"
    seqs = ["".join(letters[c] for c in rng.integers(0, 20, n))
            for n in rng.integers(0, 300, 200)]
    query = "".join(letters[c] for c in rng.integers(0, 20, 90))
    seqs[7] = "MK" + query[10:70] + "W"
    db = pt.Database(seqs)
    card, cpu = pt.Aligner(device=dev), pt.Aligner(device="cpu")

    def rows(hits):
        return [(h.target_index, h.score, h.query_start, h.query_end,
                 h.target_start, h.target_end, h.cigar()) for h in hits]

    for algo in ("nw", "hw", "ov", "sw"):
        before = dict(traceback.launches)
        got = card.align(query, db, mode="full", algorithm=algo)
        assert all(traceback.launches[k] > before[k] for k in before)
        assert rows(got) == rows(cpu.align(query, db, mode="full",
                                           algorithm=algo))
        assert rows(card.align_top_k(query, db, k=9, algorithm=algo)) == rows(
            cpu.align_top_k(query, db, k=9, algorithm=algo))
