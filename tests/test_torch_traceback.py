"""Full-mode traceback of the port against `pyopal_tpu`, on the CPU.

`pyopal_tpu_torch.ops.traceback` holds T1 (the direction pass) and T2
(the walk); on the CPU their wrappers run the plain versions, and the
tests also run `dirs_warp_reference` and `walk_thread_reference`, defined
here: CPU emulations of T1 and T2 as their CUDA kernels compute them.
Every comparison is exact (integers, bytes and CIGAR strings; tolerance
0), on inputs made from a numpy seed: the reference's jitted
`_dir_matrix_batch` and `_walk_batch_device`, its
`full_alignments_batch`, and the scalar oracle `naive.traceback`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyopal_tpu.ops import naive as ref_naive
from pyopal_tpu.ops import traceback as ref_tb
from pyopal_tpu_torch import Database
from pyopal_tpu_torch.matrices import ScoringMatrix
from pyopal_tpu_torch.models import ALGORITHMS
from pyopal_tpu_torch.ops import engine, naive
from pyopal_tpu_torch.ops import traceback as tb
from pyopal_tpu_torch.results import OP_DEL, OP_INS, OP_MATCH, cigar_string

ALGOS = ["nw", "hw", "ov", "sw"]
S = ScoringMatrix.from_name("BLOSUM50").int_data()
GAPS = [(3, 1), (1, 3), (0, 0)]


def _wrap32(x):
    """An int64 array wrapped to int32, as the kernel's int32 math."""
    return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31).astype(
        np.int32)


def dirs_warp_reference(prof_t, targets, go, ge, algorithm, lengths):
    """T1 as its kernel computes it, on the CPU: one warp per pair, 32
    rows a strip, lane ``r`` at step ``t`` on column ``t - r + 1``, the
    row above by a shuffle (lane 0: the strip above's bottom row from the
    buffer), the sequential F, the zero-filled columns past each length.
    Same arguments and result as `tb._dir_matrix_batch`.
    """
    spec = ALGORITHMS[algorithm]
    prof = prof_t.cpu().numpy().astype(np.int64)
    tg = targets.cpu().numpy()
    Q, _ = prof.shape
    B, T_pad = tg.shape
    go, ge = tb._i32(go), tb._i32(ge)
    out = np.zeros((B, Q, T_pad), np.uint8)
    lane = np.arange(32)

    def gap_run(k):  # -(go + k * ge): the boundary of row or column k + 1
        return _wrap32(-(go + np.asarray(k, np.int64) * ge))

    for b in range(B):
        n = min(max(int(lengths[b]), 0), T_pad)
        if n == 0 or Q == 0:
            continue
        bh = np.zeros(T_pad, np.int32)
        bf = np.zeros(T_pad, np.int32)
        n_strips = -(-Q // 32)
        for s in range(n_strips):
            i = s * 32 + lane + 1
            row_ok = i <= Q
            prow = prof[np.minimum(i, Q) - 1]  # (32, A)
            hl = gap_run(i - 1) if spec.penalize_first_col else \
                np.zeros(32, np.int32)
            el = np.full(32, tb.NEG, np.int32)
            hc, fc = hl.copy(), el.copy()
            saved = np.zeros(32, np.int32)
            if spec.penalize_first_col and s > 0:
                saved[0] = gap_run(s * 32 - 1)
            for t in range(n + 31):
                j = t - lane + 1
                up_h = np.concatenate([hc[:1], hc[:-1]])  # shfl_up
                up_f = np.concatenate([fc[:1], fc[:-1]])
                active = (j >= 1) & (j <= n)
                if active[0]:
                    if s == 0:
                        up_h[0] = (gap_run(j[0] - 1)
                                   if spec.penalize_first_row else 0)
                        up_f[0] = tb.NEG
                    else:
                        up_h[0], up_f[0] = bh[j[0] - 1], bf[j[0] - 1]
                diag_h, saved = saved, up_h
                m = active & row_ok
                if not m.any():
                    continue
                hg, eg = _wrap32(hl.astype(np.int64) - go), \
                    _wrap32(el.astype(np.int64) - ge)
                e = np.maximum(hg, eg)
                fg, ff = _wrap32(up_h.astype(np.int64) - go), \
                    _wrap32(up_f.astype(np.int64) - ge)
                f = np.maximum(fg, ff)
                sym = tg[b, np.clip(j - 1, 0, T_pad - 1)]
                dg = _wrap32(diag_h.astype(np.int64) + prow[lane, sym])
                tmp = np.maximum(dg, e)
                if spec.clamp_zero:
                    tmp = np.maximum(tmp, 0)
                h = np.maximum(tmp, f)
                code = np.where(h == dg, tb.DIR_DIAG,
                                np.where(h == e, tb.DIR_E, tb.DIR_F))
                if spec.clamp_zero:
                    code = np.where(h == 0, tb.DIR_STOP, code)
                byte = (code + (hg >= eg) * tb.E_OPEN
                        + (fg >= ff) * tb.F_OPEN)
                out[b, i[m] - 1, j[m] - 1] = byte[m]
                hl = np.where(m, h, hl)
                el = np.where(m, e, el)
                hc = np.where(m, h, hc)
                fc = np.where(m, f, fc)
                if m[31] and s < n_strips - 1:
                    bh[j[31] - 1], bf[j[31] - 1] = h[31], f[31]
    return torch.from_numpy(out)


def walk_thread_reference(dirs, qes, tes, algorithm):
    """T2 as its kernel computes it, on the CPU: each pair on its own,
    stepping until it is done or ``LMAX`` steps have run, into a buffer
    pre-filled with 255.  Same arguments and result as
    `tb._walk_batch_device`.
    """
    spec = ALGORITHMS[algorithm]
    d_all = dirs.cpu().numpy()
    B, Qd, T_pad = d_all.shape
    lmax = 2 * (Qd + T_pad) + 4
    cells = Qd * T_pad
    buf = np.full((lmax, B), 255, np.uint8)
    i_out = np.zeros(B, np.int32)
    j_out = np.zeros(B, np.int32)
    for b in range(B):
        flat = d_all[b].reshape(-1)
        i, j = int(qes[b]) + 1, int(tes[b]) + 1
        st = 0
        done = i == 0 and j == 0
        s = 0
        while s < lmax and not done:
            idx = min(max((i - 1) * T_pad + (j - 1), 0), cells - 1)
            d = int(flat[idx]) if cells > 0 else 0
            code = d & 3
            in_h, in_e, in_f = st == 0, st == 1, st == 2
            i0, j0 = i == 0, j == 0
            h_ins = spec.penalize_first_row and in_h and i0
            h_stop_i0 = not spec.penalize_first_row and in_h and i0
            h_del = spec.penalize_first_col and in_h and not i0 and j0
            h_stop_j0 = (not spec.penalize_first_col and in_h and not i0
                         and j0)
            h_inner = in_h and not i0 and not j0
            h_stop_clamp = (spec.clamp_zero and h_inner
                            and code == tb.DIR_STOP)
            e_open = bool(d & tb.E_OPEN) if i > 0 else True
            f_open = bool(d & tb.F_OPEN) if j > 0 else True
            emit = 255
            if h_ins or in_e:
                emit = OP_INS
            if h_del or in_f:
                emit = OP_DEL
            if h_inner and code == tb.DIR_DIAG:
                emit = OP_MATCH
            diag = h_inner and code == tb.DIR_DIAG
            i2 = i - int(h_del or diag or in_f)
            j2 = j - int(h_ins or diag or in_e)
            done = h_stop_i0 or h_stop_j0 or h_stop_clamp or (
                i2 == 0 and j2 == 0)
            if h_inner and code == tb.DIR_E:
                st = 1
            elif h_inner and code == tb.DIR_F and not h_stop_clamp:
                st = 2
            elif in_e:
                st = 0 if e_open else 1
            elif in_f:
                st = 0 if f_open else 2
            buf[s, b] = emit
            i, j = i2, j2
            s += 1
        i_out[b], j_out[b] = i, j
    return (torch.from_numpy(buf), torch.from_numpy(i_out),
            torch.from_numpy(j_out))


def _batch(seed, Q, B=8, T_pad=128, alphabet=24, matrix=S):
    """A query profile and a padded batch of targets with edge lengths
    (0, 1 and T_pad among them), as numpy arrays."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, alphabet, Q).astype(np.uint8)
    lens = rng.integers(0, T_pad + 1, B).astype(np.int32)
    lens[:3] = [T_pad, 0, 1][: min(B, 3)]
    tgt = np.zeros((B, T_pad), np.int32)
    for b in range(B):
        tgt[b, : lens[b]] = rng.integers(0, alphabet, lens[b])
    tgt[0, 5:25] = q[:20]  # a high-scoring stretch
    prof = np.ascontiguousarray(
        np.asarray(matrix, np.int32)[q.astype(np.int64)])
    return q, prof, tgt, lens


def _ref_dirs(prof, tgt, go, ge, algo, int_lookup=False):
    return np.array(ref_tb._dir_matrix_batch(
        jnp.asarray(prof), jnp.asarray(tgt), go, ge, algo,
        int_lookup=int_lookup))


def _full_lengths(tgt):
    """Every column of a ``(B, T_pad)`` batch, as lengths."""
    return torch.full((tgt.shape[0],), tgt.shape[1], dtype=torch.int32)


def _assert_region_equal(got, want, lens):
    """Byte-equal on each pair's ``[0, Q) x [0, len)`` region."""
    assert got.shape == want.shape
    for b, n in enumerate(lens):
        np.testing.assert_array_equal(got[b, :, :n], want[b, :, :n],
                                      err_msg=f"pair {b}")


@pytest.mark.parametrize("gaps", GAPS)
@pytest.mark.parametrize("algo", ALGOS)
def test_dir_matrix_plain_matches_reference(algo, gaps):
    """T1's plain version: every column equal at full lengths, the length
    region at the pairs' lengths (and zeros beyond)."""
    q, prof, tgt, lens = _batch(1, 45)
    want = _ref_dirs(prof, tgt, *gaps, algo)
    before = dict(tb.plain_calls)
    full = tb._dir_matrix_batch(torch.from_numpy(prof), torch.from_numpy(tgt),
                                *gaps, algo, _full_lengths(tgt)).numpy()
    np.testing.assert_array_equal(full, want)
    got = tb._dir_matrix_batch(torch.from_numpy(prof), torch.from_numpy(tgt),
                               *gaps, algo, torch.from_numpy(lens)).numpy()
    _assert_region_equal(got, want, lens)
    for b, n in enumerate(lens):
        assert not got[b, :, n:].any()
    assert tb.plain_calls["traceback_dirs"] == before["traceback_dirs"] + 2
    assert tb.launches == {"traceback_dirs": 0, "traceback_walk": 0}


@pytest.mark.parametrize("case", ["random32", "int_lookup"])
def test_dir_matrix_plain_other_matrices(case):
    """A random 32 x 32 matrix over 32 symbols, and entries beyond the
    f32-exact window that take the reference's ``int_lookup`` path."""
    rng = np.random.default_rng(7)
    if case == "random32":
        m = rng.integers(-9, 10, (32, 32))
        m = ((m + m.T) // 2).astype(np.int32)
        alphabet, int_lookup = 32, False
    else:
        m = rng.integers(-(2**25), 2**25, (24, 24)).astype(np.int32)
        m = np.maximum(m, m.T)
        alphabet, int_lookup = 24, True
    for algo in ALGOS:
        q, prof, tgt, lens = _batch(3, 37, alphabet=alphabet, matrix=m)
        want = _ref_dirs(prof, tgt, 3, 1, algo, int_lookup=int_lookup)
        got = tb.dir_matrix_reference(torch.from_numpy(prof),
                                      torch.from_numpy(tgt), 3, 1, algo,
                                      _full_lengths(tgt))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=algo)


@pytest.mark.parametrize("gaps", [(3, 1), (1, 3)])
@pytest.mark.parametrize("algo", ALGOS)
def test_dir_kernel_emulation_matches_reference(algo, gaps):
    """T1 as its kernel computes it (a warp per pair, 32-row strips, the
    strip buffer): three strips, the last one partial."""
    q, prof, tgt, lens = _batch(11, 70, B=4)
    want = _ref_dirs(prof, tgt, *gaps, algo)
    got = dirs_warp_reference(torch.from_numpy(prof),
                                 torch.from_numpy(tgt), *gaps, algo,
                                 torch.from_numpy(lens)).numpy()
    _assert_region_equal(got, want, lens)
    plain = tb.dir_matrix_reference(torch.from_numpy(prof),
                                    torch.from_numpy(tgt), *gaps, algo,
                                    torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(got, plain)


def _ends(q, tgt, lens, go, ge, algo):
    """The oracle's ends per pair, (-1, -1) where the walk does not
    serve it (empty target, sw's empty alignment)."""
    qes = np.full(len(lens), -1, np.int32)
    tes = np.full(len(lens), -1, np.int32)
    for b, n in enumerate(lens):
        if n == 0:
            continue
        _, qe, te = naive.score_end(q, tgt[b, :n], S, go, ge, algo)
        if algo == "sw" and (qe < 0 or te < 0):
            continue
        qes[b], tes[b] = qe, te
    return qes, tes


@pytest.mark.parametrize("gaps", [(3, 1), (1, 3), (0, 0)])
@pytest.mark.parametrize("algo", ALGOS)
def test_walk_matches_reference(algo, gaps):
    """T2's plain version and its kernel's emulation against the
    reference's device walk: ``buf``, ``i`` and ``j``; semi-global ends
    on column 0 (``te == -1``) included."""
    q, prof, tgt, lens = _batch(17, 30, B=8, T_pad=128)
    dirs = _ref_dirs(prof, tgt, *gaps, algo)
    qes, tes = _ends(q, tgt, lens, *gaps, algo)
    if algo in ("hw", "ov"):
        qes[3], tes[3] = len(q) - 1, -1  # an end on the j = 0 boundary
    want = [np.array(x) for x in ref_tb._walk_batch_device(
        jnp.asarray(dirs), jnp.asarray(qes), jnp.asarray(tes), algo)]
    args = (torch.from_numpy(dirs), torch.from_numpy(qes),
            torch.from_numpy(tes), algo)
    before = tb.plain_calls["traceback_walk"]
    for fn in (tb._walk_batch_device, walk_thread_reference):
        got = fn(*args)
        for g, w, name in zip(got, want, ("buf", "i", "j")):
            assert g.dtype == (torch.uint8 if name == "buf" else torch.int32)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert tb.plain_calls["traceback_walk"] == before + 1
    # the host walk follows the same path
    buf, i_s, j_s = want
    for b in range(len(lens)):
        if qes[b] < 0 and tes[b] < 0:
            continue
        qs, ts, ops = tb._walk(dirs[b], ALGORITHMS[algo], 0,
                               int(qes[b]), int(tes[b]), *gaps)
        col = buf[:, b]
        assert (qs, ts) == (int(i_s[b]), int(j_s[b]))
        assert list(col[col != 255][::-1]) == ops


def _full_rows(q, targets, go, ge, algo):
    ends = ([], [], [])
    for t in targets:
        for k, x in enumerate(naive.score_end(q, t, S, go, ge, algo)):
            ends[k].append(x)
    return ends


def _same_rows(got, want, what):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert tuple(g[:5]) == tuple(w[:5]), (what, k)
        np.testing.assert_array_equal(g[5], w[5], err_msg=f"{what} {k}")
        assert cigar_string(g[5]) == cigar_string(w[5])


@pytest.mark.parametrize("gaps", GAPS)
@pytest.mark.parametrize("algo", ALGOS)
def test_full_alignments_batch_matches_reference(algo, gaps):
    """Against the reference's `full_alignments_batch` and the oracle,
    with an empty target and lengths across the 128-column quantum."""
    rng = np.random.default_rng(23)
    q = rng.integers(0, 24, 33).astype(np.uint8)
    targets = [rng.integers(0, 24, int(n)).astype(np.uint8)
               for n in (0, 1, 5, 40, 127, 128, 129, 60)]
    targets[3][4:24] = q[:20]
    ends = _full_rows(q, targets, *gaps, algo)
    got = tb.full_alignments_batch(q, targets, S, *gaps, algo, ends,
                                   device="cpu")
    want = ref_tb.full_alignments_batch(q, targets, S, *gaps, algo, ends)
    _same_rows(got, want, "reference")
    oracle = [naive.traceback(q, t, S, *gaps, algo) for t in targets]
    _same_rows(got, oracle, "oracle")


@pytest.mark.parametrize("budget, scalar", [
    (2048, [5, 40, 200, 300]),  # 30 x 128 > 2048: every pair
    (4096, [200, 300]),  # 30 x 256 > 4096; 5 and 40 in two batches
])
def test_oversized_pairs_take_the_scalar_path(monkeypatch, budget, scalar):
    """The reference's `MAX_DEVICE_CELLS` fallback
    (``tests/test_engines.py``): pairs over the budget take
    `naive.traceback` in both packages, the others the batches."""
    monkeypatch.setattr(tb, "MAX_DEVICE_CELLS", budget)
    monkeypatch.setattr(ref_tb, "MAX_DEVICE_CELLS", budget)
    rng = np.random.default_rng(23)
    q = rng.integers(0, 24, 30).astype(np.uint8)
    targets = [rng.integers(0, 24, int(n)).astype(np.uint8)
               for n in (5, 40, 200, 300)]
    calls = []
    real = naive.traceback
    monkeypatch.setattr(naive, "traceback",
                        lambda *a: calls.append(len(a[1])) or real(*a))
    for algo in ALGOS:
        calls.clear()
        ends = _full_rows(q, targets, 3, 1, algo)
        got = tb.full_alignments_batch(q, targets, S, 3, 1, algo, ends,
                                       device="cpu")
        assert sorted(calls) == scalar
        _same_rows(got, ref_tb.full_alignments_batch(
            q, targets, S, 3, 1, algo, ends), algo)
        _same_rows(got, [ref_naive.traceback(q, t, S, 3, 1, algo)
                         for t in targets], algo)


@pytest.mark.parametrize("algo", ALGOS)
def test_empty_query_and_targets(algo):
    """An empty query (every pair degenerate) and empty targets."""
    rng = np.random.default_rng(5)
    targets = [rng.integers(0, 24, int(n)).astype(np.uint8)
               for n in (0, 3, 0, 130)]
    for q in (np.zeros(0, np.uint8), rng.integers(0, 24, 9).astype(np.uint8)):
        ends = _full_rows(q, targets, 3, 1, algo)
        got = tb.full_alignments_batch(q, targets, S, 3, 1, algo, ends,
                                       device="cpu")
        _same_rows(got, ref_tb.full_alignments_batch(
            q, targets, S, 3, 1, algo, ends), algo)


def test_guards_fire_as_runtime_error(monkeypatch):
    """The kernel-score guard of `engine._full_rows_for` and the span
    guard of `full_alignments_batch` raise `RuntimeError` (never a bare
    assert, which ``-O`` would drop)."""
    db = Database(["MKVLATAGG", "AAAA"])
    q = np.frombuffer(db.alphabet.encode("MKVLAT"), np.uint8)
    with db.lock.read:
        s, qe, te = engine.search_scores(db, 0, 2, q, S, 3, 1, "sw",
                                         device="cpu")
        monkeypatch.setattr(tb, "MAX_DEVICE_CELLS", 1)  # scalar path
        with pytest.raises(RuntimeError, match="kernel score"):
            engine._full_rows_for(db, np.arange(2), q, S, 3, 1, "sw",
                                  (s + 1, qe, te), "cpu")
        monkeypatch.undo()
        real = tb.walk_reference

        def shifted(*args):
            buf, i, j = real(*args)
            return buf, i + 1, j

        monkeypatch.setattr(tb, "walk_reference", shifted)
        with pytest.raises(RuntimeError, match="inconsistent traceback span"):
            engine._full_rows_for(db, np.arange(2), q, S, 3, 1, "sw",
                                  (s, qe, te), "cpu")


def test_wrappers_check_their_inputs():
    prof = torch.zeros((4, 24), dtype=torch.int32)
    tgt = torch.zeros((2, 8), dtype=torch.int32)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        tb._dir_matrix_batch(prof.long(), tgt, 3, 1, "sw", lens)
    with pytest.raises(TypeError):
        tb._dir_matrix_batch(prof, tgt, 3, 1, "sw", lens.long())
    with pytest.raises(ValueError, match="invalid algorithm"):
        tb._dir_matrix_batch(prof, tgt, 3, 1, "xx", lens)
    with pytest.raises(ValueError, match="lengths"):
        tb._dir_matrix_batch(prof, tgt, 3, 1, "sw",
                             torch.zeros(3, dtype=torch.int32))
    dirs = torch.zeros((2, 4, 8), dtype=torch.uint8)
    ends = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        tb._walk_batch_device(dirs.int(), ends, ends, "sw")
    with pytest.raises(ValueError, match="qes and tes"):
        tb._walk_batch_device(dirs, ends[:1], ends, "sw")
