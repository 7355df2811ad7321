"""The long-query route against `pyopal_tpu`: K3's plain version, the
fine-tier helpers, and both long routes through the API.

`pyopal_tpu_torch.ops.ragged_long.search_flat_long` on CPU tensors runs
the plain version of the segmented CUDA kernel segment by segment; it
must equal `pyopal_tpu.ops.pallas_ragged_long.search_flat_long` (the
segmented kernel, interpreted on the CPU) with ``QSEG`` lowered to 32 in
both packages, with tolerance 0: both compute integer DP.  The CUDA
kernel itself is held against the plain version on the card
(``test_torch_gpu.py`` and ``chip_smoke.py``).

The interpreted reference kernel is slow on the CPU (seconds to compile
each algorithm and mode, ~0.1 s per 32-row segment), so every
comparison here uses one small database whose flat pack keeps the same
shapes, and the API tests make a 100-residue query "long" by lowering
the 4096-row tier ceiling in both packages instead of sending a
4097-residue query through 129 segments.  One real 4,200-residue query
takes the fine tier.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyopal_tpu as po
import pyopal_tpu_torch as pt
from pyopal_tpu.matrices import ScoringMatrix
from pyopal_tpu.ops import engine as ref_engine
from pyopal_tpu.ops import packing as ref_packing
from pyopal_tpu.ops import pallas_ragged as pr
from pyopal_tpu.ops import pallas_ragged_long as prl
from pyopal_tpu_torch.ops import ragged, ragged_long, sweep
import _torch_cpu  # noqa: F401  (torch threads: a worker's share)

S = ScoringMatrix.from_name("BLOSUM50").int_data()
ALGOS = ["nw", "hw", "ov", "sw"]
LETTERS = "ARNDCQEGHILKMFPSTWYV"
#: target lengths: the edges of the 64-column chunk, then seeded random
#: ones; the 129-residue target (index 5) sets the pack's shapes, and a
#: slice that drops the first and last targets keeps them
LENGTHS = [0, 1, 63, 64, 65, 129] + [
    int(n) for n in np.random.default_rng(23).integers(0, 90, 30)
]


def _targets():
    rng = np.random.default_rng(29)
    return [rng.integers(0, 20, n).astype(np.uint8) for n in LENGTHS]


def _query(Q, seed):
    """A random query holding 30 residues of the 129-residue target (a
    high-scoring stretch)."""
    q = np.random.default_rng(seed).integers(0, 20, Q).astype(np.uint8)
    at = min(10, Q - 30)
    q[at : at + 30] = _targets()[5][50:80]
    return q


@pytest.fixture
def qseg32(monkeypatch):
    monkeypatch.setattr(prl, "QSEG", 32)
    monkeypatch.setattr(ragged_long, "QSEG", 32)


@pytest.mark.parametrize(
    "algo, with_ends", list(itertools.product(ALGOS, [False, True]))
)
def test_segmented_plain_matches_reference(qseg32, algo, with_ends):
    """2, 3 and 4 segments of 32 rows, every lane of the pack, all three
    planes in both modes (in score mode the end planes that the
    reference's finalize writes from untracked positions)."""
    fp = ref_packing.pack_sequences_flat(_targets())
    flat = (fp.flat_targets, fp.lengths, fp.block_of_step, fp.chunk_of_step,
            fp.last_of_step)
    ref_flat = [jnp.asarray(a) for a in flat]
    port_flat = [torch.from_numpy(a) for a in flat]
    for Q in (33, 70, 100):
        q = _query(Q, Q)
        ref = prl.search_flat_long(
            q, S, *ref_flat, 3, 1, algo, with_ends, interpret=True,
            chunk=fp.chunk,
        )
        before = ragged_long.plain_calls
        got = ragged_long.search_flat_long(
            q, S, *port_flat, 3, 1, algo, with_ends, chunk=fp.chunk
        )
        assert ragged_long.plain_calls - before == -(-Q // 32)
        for r, g in zip(ref, got):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("algo", ALGOS)
def test_fine_tier_helpers_match_reference(algo):
    Qs = list(range(-1, 9000, 37)) + [4096, 4097, 5120, 5121, 6144, 6145,
                                      8704, 8705, 35000]
    for Q in Qs:
        for with_ends in (False, True):
            assert ragged.supports_fine(Q, algo, with_ends) == (
                pr.supports_fine(Q, algo, with_ends)
            ), (Q, with_ends)
            if Q > 0:
                assert ragged.fine_qpad(Q) == pr.fine_qpad(Q)
                assert ragged.v2_scratch_bytes(
                    Q, algo, with_ends
                ) == pr.v2_scratch_bytes(Q, algo, with_ends)


def test_segment_wrapper_rejects_bad_inputs():
    fp = ref_packing.pack_sequences_flat(_targets())
    flat = [torch.from_numpy(a) for a in (
        fp.flat_targets, fp.lengths, fp.block_of_step, fp.chunk_of_step,
        fp.last_of_step)]
    prof = ragged.make_profiles_host([_query(40, 1)], S, q_pad=64)[0, 32:]
    prof = torch.from_numpy(prof)
    hb = torch.zeros(flat[0].shape, dtype=torch.int32)
    trk = torch.zeros((5, fp.n_blocks, 128), dtype=torch.int32)
    args = [prof, 40, 32, *flat, hb, hb, trk, 3, 1, "sw", True]
    for i, bad, exc in (
        (0, prof.float(), TypeError),  # profile type
        (2, 40, ValueError),  # offset past the query
        (8, hb[:-1].contiguous(), ValueError),  # boundary shape
        (10, trk[:4].contiguous(), ValueError),  # tracker shape
        (13, "xx", ValueError),  # algorithm
    ):
        with pytest.raises(exc):
            ragged_long.search_segment(*args[:i], bad, *args[i + 1:])
    assert ragged_long.launches == 0  # CPU tensors never launch the kernel


def _api_pair(max_len=None):
    targets = [
        "".join(LETTERS[c] for c in t) for t in _targets()
        if max_len is None or len(t) <= max_len
    ]
    return po.Aligner(), po.Database(targets), pt.Aligner(device="cpu"), \
        pt.Database(targets)


def _assert_same(got, ref):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys()
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        return
    assert [_fields(g) for g in got] == [_fields(r) for r in ref]


def _fields(result):
    return (type(result).__name__, result.target_index, result.score,
            getattr(result, "query_end", None),
            getattr(result, "target_end", None))


def _counts():
    return (ragged_long.plain_calls, ragged.plain_calls["ragged"],
            sweep.launches)


def test_fine_tier_route_matches_reference(monkeypatch):
    """A 4,200-residue query through `align`: one K1 plain run at the
    4,608-row fine tier in the port, the fine-tier kernel (interpreted)
    in the reference, against targets of one 64-column chunk."""
    monkeypatch.setattr(ref_engine, "_INTERPRET", True)
    ref_al, ref_db, al, db = _api_pair(max_len=64)
    query = "".join(LETTERS[c] for c in _query(4200, 4200))
    assert ragged.fine_qpad(4200) == 4608
    before = _counts()
    got = al.align(query, db, mode="end")
    after = _counts()
    _assert_same(got, ref_al.align(query, ref_db, mode="end"))
    assert [a - b for a, b in zip(after, before)] == [0, 1, 0]


@pytest.mark.parametrize(
    "algo, mode", list(itertools.product(ALGOS, ["score", "end"]))
)
def test_segmented_route_matches_reference(qseg32, monkeypatch, algo, mode):
    """A query that neither a power-of-two tier nor a fine tier takes
    goes through the segmented kernel in both packages, in `align`,
    `align_batch` (beside an empty query) and `align_arrays` over a
    slice; the port runs K3's plain version, 4 segments per call, and
    neither K1 nor the sweep."""
    monkeypatch.setattr(ref_engine, "_INTERPRET", True)
    for mod in (pr, ragged):
        monkeypatch.setattr(mod, "supports_fine", lambda *a: False)
    monkeypatch.setattr(pr, "RAGGED_MAX_QPAD_STRIP", 64)
    monkeypatch.setattr(ragged, "RAGGED_MAX_QPAD_STRIP", 64)
    ref_al, ref_db, al, db = _api_pair()
    query = "".join(LETTERS[c] for c in _query(100, 7))
    kw = dict(mode=mode, algorithm=algo)
    end = len(LENGTHS) - 1
    before = _counts()
    got = (
        al.align(query, db, **kw),
        al.align_batch([query, ""], db, **kw),
        al.align_arrays([query], db, start=1, end=end, **kw),
    )
    after = _counts()
    # the reference's `align` is its `align_batch` of one query, and its
    # `align_arrays` over a slice the same results as arrays: one
    # reference call serves all three of the port's
    ref_batch = ref_al.align_batch([query, ""], ref_db, **kw)
    _assert_same(got[0], ref_batch[0])
    for g, r in zip(got[1], ref_batch):
        _assert_same(g, r)
    hits = sorted(ref_batch[0], key=lambda r: r.target_index)[1:end]
    want = {"scores": [r.score for r in hits]}
    if mode == "end":
        want["query_ends"] = [r.query_end for r in hits]
        want["target_ends"] = [r.target_end for r in hits]
    _assert_same(got[2], {k: np.array([v], np.int32) for k, v in want.items()})
    assert [a - b for a, b in zip(after, before)] == [3 * 4, 0, 0]


def test_segmented_batch_beside_short_query(qseg32, monkeypatch):
    """A batch of the segmented query and a short one: the short query
    keeps its K1 launch."""
    monkeypatch.setattr(ref_engine, "_INTERPRET", True)
    for mod in (pr, ragged):
        monkeypatch.setattr(mod, "supports_fine", lambda *a: False)
    monkeypatch.setattr(pr, "RAGGED_MAX_QPAD_STRIP", 64)
    monkeypatch.setattr(ragged, "RAGGED_MAX_QPAD_STRIP", 64)
    ref_al, ref_db, al, db = _api_pair()
    query = "".join(LETTERS[c] for c in _query(70, 9))
    queries = [query, query[:30]]
    before = _counts()
    got = al.align_batch(queries, db, mode="end")
    after = _counts()
    for g, r in zip(got, ref_al.align_batch(queries, ref_db, mode="end")):
        _assert_same(g, r)
    assert [a - b for a, b in zip(after, before)] == [3, 1, 0]
