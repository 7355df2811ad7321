"""The grouped kernel's route against `pyopal_tpu`: K6's plain version,
its profile, and the grouped packing.

`pyopal_tpu_torch.ops.group.search_group` on CPU tensors runs the plain
version of the grouped CUDA kernel; it must equal
`pyopal_tpu.ops.pallas_kernel.search_group` (the Pallas kernel,
interpreted on the CPU, as ``tests/test_engines.py`` runs it) on every
lane and in all three output planes, with tolerance 0: both compute
integer DP.  The CUDA kernel itself is held against the plain version on
the card (``test_torch_gpu.py`` and ``chip_smoke.py``).

The interpreted reference compiles once per algorithm, mode, gap pair and
query length, so the gap pairs are spread across the algorithms instead
of taken in a full product.
"""

import numpy as np
import pytest
import torch

import pyopal_tpu as po
import pyopal_tpu_torch as pt
from pyopal_tpu.matrices import ScoringMatrix
from pyopal_tpu.ops import packing as ref_packing
from pyopal_tpu.ops import pallas_kernel as pk
from pyopal_tpu_torch.ops import group, packing
import _torch_cpu  # noqa: F401  (torch threads: a worker's share)

S = ScoringMatrix.from_name("BLOSUM50").int_data()
ALGOS = ["nw", "hw", "ov", "sw"]
#: edge target lengths of the 256-column chunk and the 32-column quantum
EDGES = [0, 1, 31, 32, 33, 255, 256, 257, 300]

CASES = (
    [(a, e, (3, 1), 13) for a in ALGOS for e in (False, True)]
    + [(a, True, (1, 3), 29) for a in ALGOS]
    + [(a, a in ("hw", "sw"), (0, 0), 40) for a in ALGOS]
)


def _group(seed):
    """Two blocks of 128 lanes at t_pad 512: block 0 starts with the edge
    lengths, every block holds zero-length lanes, and symbols fill the
    columns past each length too (neither kernel may read them into a
    result)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 301, (2, 128)).astype(np.int32)
    lengths[0, : len(EDGES)] = EDGES
    lengths[1, -3:] = 0
    targets = rng.integers(0, 24, (2, 512, 128)).astype(np.uint8)
    return targets, lengths


@pytest.mark.parametrize("algo, with_ends, gaps, Q", CASES)
def test_plain_matches_reference(algo, with_ends, gaps, Q):
    targets, lengths = _group(Q)
    q = np.random.default_rng(100 + Q).integers(0, 24, Q).astype(np.uint8)
    q[:10] = targets[0, 20:30, 7]  # a high-scoring stretch of lane 7
    go, ge = gaps
    ref = pk.search_group(
        pk.make_profile(q, S), targets.astype(np.int32), lengths, go, ge,
        algo, with_ends=with_ends, interpret=True,
    )
    # the wrapper takes uint8 (the grouped pack's) or int32 targets
    tgt = torch.from_numpy(targets)
    if algo in ("nw", "ov"):
        tgt = tgt.to(torch.int32)
    before = (group.plain_calls, group.launches)
    got = group.search_group(
        group.make_profile(q, S, "cpu"), tgt, torch.from_numpy(lengths),
        go, ge, algo, with_ends,
    )
    assert (group.plain_calls, group.launches) == (before[0] + 1, before[1])
    for r, g in zip(ref, got):
        assert g.dtype == torch.int32 and g.shape == (2, 128)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_profile_and_supports_match_reference():
    rng = np.random.default_rng(5)
    for Q in (0, 1, 7, 8, 13, 29, 40, 1000):
        q = rng.integers(0, 24, Q).astype(np.uint8)
        got = group.make_profile_host(q, S)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, pk.make_profile_host(q, S))
        prof, n = group.make_profile(q, S, "cpu")
        assert n == Q and torch.equal(prof, torch.from_numpy(got))
    for Q in list(range(-1, 5000, 37)) + [4096, 4097]:
        assert group.supports(Q) == pk.supports(Q)


@pytest.mark.parametrize("lanes", [128, 64])
def test_pack_sequences_matches_reference(lanes):
    rng = np.random.default_rng(lanes)
    lens = [0, 1, 15, 16, 17, 32, 33, 256, 257, 513] + [
        int(n) for n in rng.integers(0, 700, 300)
    ]
    seqs = [rng.integers(0, 24, n).astype(np.uint8) for n in lens]
    for n in range(0, 1100):
        assert packing._quantize_length(n) == ref_packing._quantize_length(n)
    got = packing.pack_sequences(seqs, lanes=lanes)
    ref = ref_packing.pack_sequences(seqs, lanes=lanes)
    assert got.n_targets == ref.n_targets
    assert [g.t_pad for g in got.groups] == [g.t_pad for g in ref.groups]
    for g, r in zip(got.groups, ref.groups):
        for name in ("targets", "lengths", "indices"):
            a, b = getattr(g, name), getattr(r, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name
    assert (got.total_cells, got.total_cells_padded) == (
        ref.total_cells, ref.total_cells_padded)
    assert packing.pack_sequences([]).groups == []


def test_pack_database_slice_matches_reference():
    letters = "ARNDCQEGHILKMFPSTWYV"
    rng = np.random.default_rng(11)
    seqs = ["".join(letters[c] for c in rng.integers(0, 20, n))
            for n in rng.integers(0, 300, 150)]
    db, ref_db = pt.Database(seqs), po.Database(seqs)
    with db.lock.read, ref_db.lock.read:
        got = packing.pack_database_slice(db, 3, 140)
        ref = ref_packing.pack_database_slice(ref_db, 3, 140)
        assert packing.pack_database_slice(db, 3, 140) is got  # memoized
    assert [g.t_pad for g in got.groups] == [g.t_pad for g in ref.groups]
    for g, r in zip(got.groups, ref.groups):
        for name in ("targets", "lengths", "indices"):
            assert getattr(g, name).tobytes() == getattr(r, name).tobytes()


def test_search_group_rejects_bad_inputs():
    targets, lengths = _group(1)
    prof, Q = group.make_profile(np.arange(13, dtype=np.uint8), S, "cpu")
    tgt, lens = torch.from_numpy(targets), torch.from_numpy(lengths)
    for args, exc in (
        (((prof.float(), Q), tgt, lens), TypeError),  # profile type
        (((prof, 17), tgt, lens), ValueError),  # Q past the profile
        (((prof, 0), tgt, lens), ValueError),  # empty query
        (((prof, Q), tgt.to(torch.int64), lens), TypeError),
        (((prof, Q), tgt, lens[:1].contiguous()), ValueError),
        (((prof, Q), tgt[:, :, :64], lens[:, :64]), ValueError),
    ):
        with pytest.raises(exc):
            group.search_group(*args, 3, 1, "sw")
    with pytest.raises(ValueError):
        group.search_group((prof, Q), tgt, lens, 3, 1, "xx")
    assert group.launches == 0  # CPU tensors never launch the kernel
