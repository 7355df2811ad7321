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
from pyopal_tpu_torch.ops import ragged

S = ScoringMatrix.from_name("BLOSUM50").int_data()
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
