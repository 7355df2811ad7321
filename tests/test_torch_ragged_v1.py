"""K4's and K5's plain versions against the reference's v1 kernels.

`pyopal_tpu_torch.ops.ragged.search_flat` without ``safe_pad`` (the
reference's default) routes to K4, the full-scan kernel, or, score-only
at tiers of 512 rows and more, to K5, the strip kernel; on CPU tensors
it runs their plain versions.  They must equal
`pyopal_tpu.ops.pallas_ragged.search_flat(safe_pad=False)` (the v1
kernels, interpreted on the CPU) on every lane and plane, with tolerance
0: both compute integer DP.  The cases cover the four algorithms, both
modes (K4), gaps 3/1, 1/3 and 0/0, edge target lengths, and a 32 x 32
matrix whose targets hold symbol 31 as a real letter, which the ``safe_pad``
kernel (K1) would score as padding.  The CUDA kernels themselves are held
against the plain versions on the card (``test_torch_gpu.py`` and
``chip_smoke.py``).

The interpreted K5 is slow on the CPU, so its cases stay at the 512 tier
but one at 1024.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyopal_tpu.matrices import ScoringMatrix
from pyopal_tpu.ops import packing as ref_packing
from pyopal_tpu.ops import pallas_ragged as pr
from pyopal_tpu_torch.ops import ragged
import _torch_cpu  # noqa: F401  (torch threads: a worker's share)

S = ScoringMatrix.from_name("BLOSUM50").int_data()
ALGOS = ["nw", "hw", "ov", "sw"]
EDGE_LENGTHS = [0, 1, 63, 64, 65, 127, 128, 129]


def _seqs(seed, n=20, hi=150, alphabet=24):
    rng = np.random.default_rng(seed)
    lens = EDGE_LENGTHS + list(rng.integers(0, hi, n))
    return [rng.integers(0, alphabet, int(k)).astype(np.uint8) for k in lens]


def _queries(seed, lengths, seqs, alphabet=24):
    """Random queries, the first holding 30 residues of a target (a
    high-scoring stretch)."""
    rng = np.random.default_rng(seed)
    qs = [rng.integers(0, alphabet, n).astype(np.uint8) for n in lengths]
    qs[0][3:33] = seqs[7][40:70]
    return qs


def _compare(queries, seqs, go, ge, algo, with_ends, matrix=S):
    """The port's routed plain version against the reference kernel, on
    every plane; returns the port's output and the route taken."""
    fp = ref_packing.pack_sequences_flat(seqs)
    flat = (fp.flat_targets, fp.lengths, fp.block_of_step,
            fp.chunk_of_step, fp.last_of_step)
    qls = [len(q) for q in queries]
    ref = pr.search_flat(
        jnp.asarray(pr.make_profiles_host(queries, matrix), jnp.bfloat16),
        jnp.asarray(qls, jnp.int32), *[jnp.asarray(a) for a in flat],
        go, ge, algo, with_ends, interpret=True, chunk=fp.chunk,
    )
    profs = torch.from_numpy(ragged.make_profiles_host(queries, matrix))
    before = dict(ragged.plain_calls)
    got = ragged.search_flat(
        profs, torch.tensor(qls, dtype=torch.int32),
        *[torch.from_numpy(a) for a in flat], go, ge, algo, with_ends,
        chunk=fp.chunk,
    )
    calls = {k: n - before[k] for k, n in ragged.plain_calls.items()}
    route, = (k for k, n in calls.items() if n)
    assert calls[route] == 1 and route != "ragged"
    for r, g in zip(ref, got):
        assert g.dtype == torch.int32
        assert g.shape == (len(queries), fp.n_blocks, 128)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert not any(ragged.launches.values())  # CPU: no kernel launch
    return got, route


@pytest.mark.parametrize("with_ends", [False, True])
@pytest.mark.parametrize("algo", ALGOS)
def test_k4_plain_matches_reference(algo, with_ends):
    """Three queries at the 64 tier (one of 64 residues, no pad rows),
    gaps 3/1; in score mode the end planes the reference's finalize
    writes from untracked positions."""
    seqs = _seqs(11)
    queries = _queries(12, [40, 17, 64], seqs)
    (s, qe, te), route = _compare(queries, seqs, 3, 1, algo, with_ends)
    assert route == "ragged_v1"
    if algo == "sw" and not with_ends:
        assert (qe == -1).all() and (te == -1).all()


@pytest.mark.parametrize("algo, gaps", [("nw", (1, 3)), ("hw", (1, 3)),
                                        ("sw", (0, 0)), ("ov", (0, 0))])
def test_k4_plain_matches_reference_gaps(algo, gaps):
    """Extension dearer than opening, and zero gaps (ties everywhere,
    pad rows as good as the rows above them: sw's best cell and ov's last
    column range over them), with ends."""
    seqs = _seqs(13)
    seqs.append(np.full(80, 2, np.uint8))
    queries = _queries(14, [50, 9], seqs)
    queries[1][:] = 2
    _compare(queries, seqs, *gaps, algo, True)


@pytest.mark.parametrize("algo, gaps", [("sw", (3, 1)), ("nw", (1, 3)),
                                        ("hw", (0, 0)), ("ov", (3, 1))])
def test_k5_plain_matches_reference(algo, gaps):
    """Score-only at the 512 tier: two strips of 256 rows, queries of
    300 and 512 residues (the last row in either strip), planes -1."""
    seqs = _seqs(15, n=12, hi=300)
    queries = _queries(16, [300, 512, 257], seqs)
    (s, qe, te), route = _compare(queries, seqs, *gaps, algo, False)
    assert route == "ragged_strip"
    assert (qe == -1).all() and (te == -1).all()


def test_k5_plain_matches_reference_tier1024():
    seqs = _seqs(17, n=6, hi=200)
    queries = _queries(18, [700], seqs)
    _, route = _compare(queries, seqs, 3, 1, "ov", False)
    assert route == "ragged_strip"


@pytest.mark.parametrize("algo, with_ends, tier", [
    ("sw", True, 64), ("ov", False, 64), ("hw", False, 512),
])
def test_symbol_31_is_a_real_letter(algo, with_ends, tier):
    """A random 32 x 32 matrix; targets and queries use all 32 symbols,
    31 included, which no padding column may take for a pad symbol."""
    rng = np.random.default_rng(31)
    m = rng.integers(-6, 7, (32, 32))
    m = ((m + m.T) // 2).astype(np.int32)
    m[31, 31] = 9
    seqs = _seqs(19, n=10, hi=140, alphabet=32)
    seqs[3][:] = 31
    lengths = [40, 60] if tier == 64 else [300]
    queries = _queries(20, lengths, seqs, alphabet=32)
    queries[0][:10] = 31
    _, route = _compare(queries, seqs, 3, 1, algo, with_ends, matrix=m)
    assert route == ("ragged_v1" if tier == 64 else "ragged_strip")


def test_routing_and_errors_match_reference():
    """`supports` and the tier errors: end mode at the 4096 tier has no
    kernel without ``safe_pad`` in either package."""
    for Q in list(range(-1, 4200, 61)) + [2048, 2049, 4096, 4097]:
        for algo in ALGOS:
            for with_ends in (False, True):
                for safe_pad in (False, True):
                    assert ragged.supports(Q, algo, with_ends, safe_pad) == (
                        pr.supports(Q, algo, with_ends, safe_pad)
                    ), (Q, algo, with_ends, safe_pad)
    assert ragged.supports(3000) is pr.supports(3000) is False
    for name in ("RAGGED_MAX_QPAD", "RAGGED_MAX_QPAD_STRIP", "STRIP",
                 "STRIP_MIN_QPAD", "PAD_SYMBOL"):
        assert getattr(ragged, name) == getattr(pr, name), name

    seqs = _seqs(21, n=2)
    fp = ref_packing.pack_sequences_flat(seqs)
    flat = (fp.flat_targets, fp.lengths, fp.block_of_step,
            fp.chunk_of_step, fp.last_of_step)
    q = [np.zeros(3000, np.uint8)]
    profs = ragged.make_profiles_host(q, S)
    assert profs.shape[1] == 4096
    with pytest.raises(ValueError, match="strip-blocked") as ref_err:
        pr.search_flat(
            jnp.asarray(profs, jnp.bfloat16), jnp.asarray([3000], jnp.int32),
            *[jnp.asarray(a) for a in flat], 3, 1, "sw", True,
            interpret=True, chunk=fp.chunk,
        )
    args = (torch.from_numpy(profs), torch.tensor([3000], dtype=torch.int32),
            *[torch.from_numpy(a) for a in flat], 3, 1, "sw", True)
    with pytest.raises(ValueError) as err:
        ragged.search_flat(*args, chunk=fp.chunk)
    assert str(err.value) == str(ref_err.value)
    # K4 and K5 take query lengths in [1, Q_pad] only
    bad = (args[0], torch.tensor([0], dtype=torch.int32), *args[2:])
    with pytest.raises(ValueError, match="query lengths"):
        ragged.search_flat(*bad[:-1], False, chunk=fp.chunk)
