"""K2's plain version against the reference q8 kernel.

`pyopal_tpu_torch.ops.q8.search_flat_q8` on CPU tensors runs the plain
PyTorch version of the CUDA kernel; it must equal
`pyopal_tpu.ops.pallas_q8.search_flat_q8` (interpreted on the CPU) on
the same interleaved profiles and flat arrays, on every slot and lane
(empty slots included), with tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyopal_tpu.matrices import ScoringMatrix
from pyopal_tpu.ops import packing as ref_packing
from pyopal_tpu.ops import pallas_q8 as ref_q8
from pyopal_tpu_torch.ops import q8, ragged
import _torch_cpu  # noqa: F401  (torch threads: a worker's share)

S = ScoringMatrix.from_name("BLOSUM50").int_data()


def _compare(queries, seqs, go, ge, algo, with_ends, lanes):
    fp = ref_packing.pack_sequences_flat(seqs, lanes=lanes)
    groups = q8.plan_groups([len(q) for q in queries])
    assert groups == ref_q8.plan_groups([len(q) for q in queries])
    ref_profs, ref_qv, ref_maxq = ref_q8.make_profiles_q8_host(
        queries, S, groups, lanes=lanes
    )
    profs, qv, maxq = q8.make_profiles_q8_host(queries, S, groups, lanes=lanes)
    np.testing.assert_array_equal(profs, ref_profs.astype(np.int32))
    np.testing.assert_array_equal(qv, ref_qv)
    np.testing.assert_array_equal(maxq, ref_maxq)
    flat = (fp.flat_targets, fp.lengths, fp.block_of_step,
            fp.chunk_of_step, fp.last_of_step)
    ref = ref_q8.search_flat_q8(
        jnp.asarray(ref_profs, jnp.bfloat16), jnp.asarray(ref_qv),
        jnp.asarray(ref_maxq), *[jnp.asarray(a) for a in flat],
        go, ge, algo, with_ends, interpret=True, chunk=fp.chunk,
    )
    got = q8.search_flat_q8(
        torch.from_numpy(profs), torch.from_numpy(qv),
        torch.from_numpy(maxq), *[torch.from_numpy(a) for a in flat],
        go, ge, algo, with_ends, chunk=fp.chunk,
    )
    for r, g in zip(ref, got):
        assert g.dtype == torch.int32
        assert g.shape == (len(groups), fp.n_blocks, q8.QB, lanes)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    return got


@pytest.mark.parametrize("with_ends", [False, True])
@pytest.mark.parametrize("algo", ["nw", "hw", "ov", "sw"])
def test_plain_matches_reference(algo, with_ends):
    """14 queries: one full group and a partial group of 6 slots."""
    rng = np.random.default_rng(23)
    queries = [
        rng.integers(0, 24, n).astype(np.uint8)
        for n in (13, 1, 40, 64, 7, 66, 29, 55, 21, 3, 64, 50, 9, 33)
    ]
    lens = [0, 1, 63, 64, 65, 128, 129, 40, 90, 17]
    seqs = [rng.integers(0, 24, n).astype(np.uint8) for n in lens]
    go, ge = (3, 1) if with_ends else (1, 3)
    lanes = 512 if with_ends else 256
    s, qe, te = _compare(queries, seqs, go, ge, algo, with_ends, lanes)
    if not with_ends:
        assert (qe == -1).all() and (te == -1).all()


def test_plain_matches_reference_ties():
    """Repetitive sequences and zero gaps maximize score ties."""
    queries = [
        np.tile(np.array([0, 1], np.uint8), 20)[: 17 + i] for i in range(8)
    ]
    seqs = [
        np.tile(np.array([0, 1, 0], np.uint8), 30)[: 11 + 7 * i]
        for i in range(9)
    ]
    for algo in ("sw", "ov"):
        _compare(queries, seqs, 0, 0, algo, True, 128)


def test_wrapper_rejects_bad_inputs():
    rng = np.random.default_rng(1)
    queries = [rng.integers(0, 24, 20).astype(np.uint8) for _ in range(8)]
    fp = ref_packing.pack_sequences_flat(
        [rng.integers(0, 24, 30).astype(np.uint8)], lanes=256
    )
    groups = q8.plan_groups([len(q) for q in queries])
    profs, qv, maxq = q8.make_profiles_q8_host(queries, S, groups, lanes=128)
    flat = [torch.from_numpy(a) for a in (
        fp.flat_targets, fp.lengths, fp.block_of_step, fp.chunk_of_step,
        fp.last_of_step,
    )]
    args = [torch.from_numpy(profs), torch.from_numpy(qv),
            torch.from_numpy(maxq)]
    with pytest.raises(ValueError):  # qv built for 128 lanes, pack has 256
        q8.search_flat_q8(*args, *flat, 3, 1, "sw", True, chunk=fp.chunk)
    args[0] = args[0].float()
    with pytest.raises(TypeError):
        q8.search_flat_q8(*args, *flat, 3, 1, "sw", True, chunk=fp.chunk)
    assert not any(q8.launches.values())  # CPU: no kernel launch


def _narrow_inputs(lanes=128):
    """The 8 queries and 10 targets of the reference's narrow test
    (``tests/test_q8.py``, seed 77): a 150-residue self-hit scores past
    the cap."""
    rng = np.random.default_rng(77)
    big = rng.integers(0, 20, 150).astype(np.uint8)
    seqs = [
        rng.integers(0, 20, int(n)).astype(np.uint8)
        for n in [0, 1, 40, 63, 64, 65, 90, 150, 17, 33]
    ]
    seqs[7] = big.copy()
    queries = [
        rng.integers(0, 20, int(n)).astype(np.uint8)
        for n in (60, 44, 150, 21, 64, 15, 9, 50)
    ]
    queries[2] = big.copy()
    fp = ref_packing.pack_sequences_flat(seqs, lanes=lanes)
    groups = q8.plan_groups([len(q) for q in queries])
    arrays = q8.make_profiles_q8_host(queries, S, groups, lanes=lanes)
    flat = (fp.flat_targets, fp.lengths, fp.block_of_step,
            fp.chunk_of_step, fp.last_of_step)
    return fp, groups, arrays, flat


@pytest.mark.parametrize("gaps", [(3, 1), (0, 0)])
def test_narrow_plain_matches_reference(gaps):
    """K7's plain version against the reference's bf16 narrow pass: all
    three planes equal, scores min(sw score, NARROW_CAP), the self-hit
    flagged, both end planes -1."""
    fp, groups, arrays, flat = _narrow_inputs()
    profs, qv, maxq = arrays
    ref = ref_q8.search_flat_q8(
        jnp.asarray(profs, jnp.bfloat16), jnp.asarray(qv), jnp.asarray(maxq),
        *[jnp.asarray(a) for a in flat], *gaps, "sw", False,
        interpret=True, chunk=fp.chunk, narrow=True,
    )
    port_args = [torch.from_numpy(a) for a in (*arrays, *flat)]
    before = dict(q8.plain_calls)
    got = q8.search_flat_q8(*port_args, *gaps, "sw", False, chunk=fp.chunk,
                            narrow=True)
    before["q8_narrow"] += 1
    assert q8.plain_calls == before
    for r, g in zip(ref, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    exact = q8.search_flat_q8(*port_args, *gaps, "sw", False, chunk=fp.chunk)
    assert torch.equal(got[0], exact[0].clamp(max=q8.NARROW_CAP))
    assert (got[0] == q8.NARROW_CAP).sum() >= 1
    assert (got[1] == -1).all() and (got[2] == -1).all()
    assert not any(q8.launches.values())


@pytest.mark.parametrize("bad", [
    dict(go=3, ge=1, algo="nw", with_ends=False),
    dict(go=3, ge=1, algo="sw", with_ends=True),
    dict(go=300, ge=1, algo="sw", with_ends=False),
])
def test_narrow_rejects_unsupported_configs(bad):
    """Outside sw score-only with gaps in [0, 255], both packages raise
    the same `ValueError`."""
    fp, _, arrays, flat = _narrow_inputs()
    call = (bad["go"], bad["ge"], bad["algo"], bad["with_ends"])
    with pytest.raises(ValueError) as ref_err:
        ref_q8.search_flat_q8(
            jnp.asarray(arrays[0], jnp.bfloat16),
            *[jnp.asarray(a) for a in (*arrays[1:], *flat)], *call,
            interpret=True, chunk=fp.chunk, narrow=True,
        )
    with pytest.raises(ValueError) as err:
        q8.search_flat_q8(*[torch.from_numpy(a) for a in (*arrays, *flat)],
                          *call, chunk=fp.chunk, narrow=True)
    assert str(err.value) == str(ref_err.value)


#: The packed walk's cases: (query lengths, a query that is a stretch of
#: a target, G and R of the emulation (None: the kernel's)).  Slots pair
#: up as (0, 1), (2, 3), ... in the order given, so paired slots differ
#: in length (60/44, 9/50, 300/257); "partial" leaves one slot of the
#: last pair empty and "partial pair" a whole pair; at G = 4, R = 2 a
#: pass is 8 rows, and "tier512" walks the kernel's two passes of 256
#: rows through the pair's buffer.  The stretch scores past 255.
PACKED_CASES = {
    "full": ([60, 44, 9, 50, 17, 64, 33, 40], 5, (4, 2)),
    "partial": ([60, 44, 9, 50, 17, 64, 41], 5, (4, 2)),
    "partial pair": ([60, 44, 64, 50, 17, 12], 2, (4, 2)),
    "tier512": ([300, 257, 50, 9, 60, 61, 7, 400], 4, None),
}


def _packed_inputs(name, matrix=S):
    """One group of a case over seven targets of up to 64 residues."""
    qls, stretch, _ = PACKED_CASES[name]
    rng = np.random.default_rng(53)
    seqs = [rng.integers(0, 20, n).astype(np.uint8)
            for n in (0, 1, 30, 63, 64, 20, 50)]
    queries = [rng.integers(0, 20, n).astype(np.uint8) for n in qls]
    queries[stretch][:64] = seqs[4][: qls[stretch]]
    fp = ref_packing.pack_sequences_flat(seqs, lanes=128)
    arrays = q8.make_profiles_q8_host(queries, matrix, [list(range(len(qls)))],
                                      lanes=128)
    flat = (fp.flat_targets, fp.lengths, fp.block_of_step,
            fp.chunk_of_step, fp.last_of_step)
    return fp, [torch.from_numpy(a) for a in (*arrays, *flat)]


@pytest.mark.parametrize("name", sorted(PACKED_CASES))
def test_packed_walk_with_lifted_cap_equals_k2(name):
    """The packed walk's emulation with H's cap at Q_pad x max |S| (K2's
    exact route) equals K2's plain version on all three planes, past 255
    where a stretch of a target scores there, while K7 (``narrow``)
    still returns min(K2's score, 255).  The walk asserts every
    intermediate's int16 range for the cap."""
    fp, args = _packed_inputs(name)
    geometry = PACKED_CASES[name][2]
    G, R = geometry if geometry else (None, q8.WAVE_R)
    q_pad = args[0].shape[1] // q8.QB
    assert q_pad == (512 if name == "tier512" else 64)
    exact = q8.search_flat_q8_reference(*args, 3, 1, "sw", False, fp.chunk)
    assert int(exact[0].max()) > q8.NARROW_CAP
    cap = q_pad * int(np.abs(S).max())
    got = q8.narrow_wave_reference(*args, 3, 1, fp.chunk, G=G, R=R, cap=cap)
    for g, e in zip(got, exact):
        assert torch.equal(g, e)
    k7 = q8.search_flat_q8(*args, 3, 1, "sw", False, chunk=fp.chunk,
                           narrow=True)
    assert torch.equal(k7[0], exact[0].clamp(max=q8.NARROW_CAP))


@pytest.mark.parametrize("gaps", [(3, 1), (500, 12)])
def test_packed_walk_at_the_largest_admitted_cap(gaps):
    """BLOSUM50 times 33 (max |S| 495) at the 64 tier: the cap 31,680 is
    the largest the walk admits there (H + s + go reaches 32,704), and
    at go + ge = 512 the floor is just within reach; the emulation
    equals K2's plain version, and one more in the matrix's largest
    entry leaves int16."""
    big = S * 33
    fp, args = _packed_inputs("full", big)
    cap = 64 * int(np.abs(big).max())
    assert cap == 31680 and ragged.packed_fits(*gaps, cap)
    assert not ragged.packed_fits(*gaps, 64 * 496)
    exact = q8.search_flat_q8_reference(*args, *gaps, "sw", False, fp.chunk)
    got = q8.narrow_wave_reference(*args, *gaps, fp.chunk, G=4, R=2, cap=cap)
    for g, e in zip(got, exact):
        assert torch.equal(g, e)


def test_packed_route_on_the_cpu_is_k2s_plain_version():
    """`search_flat_q8(packed_cap=...)` on CPU tensors runs K2's plain
    version, counted under ``q8_packed``."""
    fp, args = _packed_inputs("partial")
    before = dict(q8.plain_calls)
    got = q8.search_flat_q8(*args, 3, 1, "sw", False, chunk=fp.chunk,
                            packed_cap=64 * 15)
    before["q8_packed"] += 1
    assert q8.plain_calls == before
    exact = q8.search_flat_q8_reference(*args, 3, 1, "sw", False, fp.chunk)
    for g, e in zip(got, exact):
        assert torch.equal(g, e)
    assert (got[1] == -1).all() and (got[2] == -1).all()
    assert not any(q8.launches.values())


@pytest.mark.parametrize("bad", [
    dict(gaps=(3, 1), algo="nw", with_ends=False, cap=960),
    dict(gaps=(3, 1), algo="sw", with_ends=True, cap=960),
    dict(gaps=(500, 13), algo="sw", with_ends=False, cap=960),
    dict(gaps=(-1, 2), algo="sw", with_ends=False, cap=960),
    dict(gaps=(3, 1), algo="sw", with_ends=False, cap=31744),
    dict(gaps=(3, 1), algo="sw", with_ends=False, cap=960, narrow=True),
])
def test_packed_route_rejects_what_the_walk_cannot_hold(bad):
    fp, args = _packed_inputs("full")
    with pytest.raises(ValueError):
        q8.search_flat_q8(*args, *bad["gaps"], bad["algo"], bad["with_ends"],
                          chunk=fp.chunk, narrow=bad.get("narrow", False),
                          packed_cap=bad["cap"])
