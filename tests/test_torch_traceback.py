"""Full-mode traceback of the port against `pyopal_tpu`, on the CPU.

`pyopal_tpu_torch.ops.traceback` holds T1 (the direction pass) and T2
(the walk); on the CPU their wrappers run the plain versions, and the
tests also run `dirs_wave_reference` and `walk_tiled_reference`, defined
here: CPU emulations of T1 and T2 as their CUDA kernels compute them (T1's
groups of threads, rows a thread, passes, pass buffer and store layout;
T2's tiles and the state carried across their edges), at the kernels'
own sizes and at small ones that make the same edges frequent.
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
import _torch_cpu  # noqa: F401  (torch threads: a worker's share)

ALGOS = ["nw", "hw", "ov", "sw"]
S = ScoringMatrix.from_name("BLOSUM50").int_data()
GAPS = [(3, 1), (1, 3), (0, 0)]


def _wrap32(x):
    """An int64 array wrapped to int32 values, as the kernels' int32 math
    (kept in int64)."""
    return (np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31


#: what the emulations put in their buffers first: every byte of each
#: buffer must be overwritten (direction bytes are below 16)
UNWRITTEN = 0xAA


def dirs_wave_reference(prof_t, targets, go, ge, algorithm, lengths,
                        R=tb.DIRS_R, max_g=tb.DIRS_MAX_G):
    """T1 as its kernel computes it, on the CPU, step by step.

    A group of ``G = tb.dirs_group(Q, R, max_g)`` threads a pair, thread
    ``t`` owning rows ``[base + t R, base + (t + 1) R)`` of a pass of
    ``G R`` rows; at step ``s`` it works on column ``s - t`` with the row
    above handed down from thread ``t - 1`` (thread 0: row 0's closed form
    in the first pass, else the pass buffer that thread ``G - 1`` of the
    pass before wrote), the symbol of its next column from thread ``t -
    1`` (thread 0: from the target), the profile entries of that symbol
    looked up a step ahead, the sequential F and the kernel's predicates
    (an argmax's ``a >= b``).  A thread keeps the ``R`` bytes of each
    column in a ring of ``G`` slots, and the group stores column ``s - G +
    1`` together at step ``s``, into ``(B, T_pad, Qs)`` bytes (``Qs = Q`` rounded up to ``2 R``; rows
    past Q zero), zero-fills the
    columns past each length, asserts that every byte was written, and
    returns the ``(B, Q, T_pad)`` view, as `tb._dir_matrix_batch` does on
    the card.
    """
    spec = ALGORITHMS[algorithm]
    clamp = spec.clamp_zero
    prof = prof_t.cpu().numpy().astype(np.int64)
    tg = targets.cpu().numpy().astype(np.int64)
    Q, A = prof.shape
    B, T_pad = tg.shape
    n = np.clip(lengths.cpu().numpy().astype(np.int64), 0, T_pad)
    # Q rounded up to two threads' rows: 16 at the kernel's R = 8
    Qs = -(-Q // (2 * R)) * 2 * R
    store = np.full((B, T_pad, Qs), UNWRITTEN, np.uint8)
    go, ge = tb._i32(go), tb._i32(ge)
    NEG = int(tb.NEG)
    G = tb.dirs_group(Q, R, max_g)
    GR = G * R
    n_pass = -(-Q // GR)
    assert G * R >= min(Q, max_g * R) and (n_pass == 1 or G == max_g)
    for b in range(B):
        store[b, n[b]:] = 0
    t = np.arange(G)
    bh = np.zeros((B, T_pad), np.int64)  # the pass buffer: H and F
    bf = np.zeros((B, T_pad), np.int64)
    nsteps = int(n.max()) + G - 1 if n.max() > 0 else 0

    def gap_run(k):  # -(go + k * ge): the boundary of row or column k + 1
        return _wrap32(-(go + np.asarray(k, np.int64) * ge))

    for p in range(n_pass):
        base = p * GR
        # the pass's profile rows (0 past the query), [symbol][row]
        P = np.zeros((A, GR), np.int64)
        k = min(GR, Q - base)
        P[:, :k] = prof[base:base + k].T
        q0 = base + t * R
        nv = np.clip(Q - q0, 0, R)
        rows = q0[:, None] + np.arange(R)  # (G, R)
        Gr = np.broadcast_to(_wrap32(
            (gap_run(rows) if spec.penalize_first_col else 0) - go),
            (B, G, R)).copy()
        E = np.full((B, G, R), NEG, np.int64)
        gd0 = np.where((q0 > 0) & spec.penalize_first_col, gap_run(q0 - 1), 0)
        gdiag = np.broadcast_to(_wrap32(gd0 - go), (B, G)).copy()
        out_h = np.zeros((B, G), np.int64)
        out_f = np.full((B, G), NEG, np.int64)
        use_sym = np.repeat(tg[:, :1], G, axis=1)  # thread 0's column 0
        ring = np.zeros((B, G, G, R), np.int64)  # [column % G][thread]
        pv_next = P[use_sym[..., None], t[:, None] * R + np.arange(R)]
        for s in range(nsteps):
            c = s + 1
            nsym = np.concatenate([tg[:, c:c + 1] if c < T_pad else
                                   np.zeros((B, 1), np.int64),
                                   use_sym[:, :-1]], axis=1)
            if p == 0:
                top_h = np.full(B, gap_run(s) if spec.penalize_first_row
                                else 0)
                top_f = np.full(B, NEG)
            elif s < T_pad:
                top_h, top_f = bh[:, s], bf[:, s]
            else:  # past the buffer: thread 0 is idle
                top_h = top_f = np.zeros(B, np.int64)
            hu = np.concatenate([top_h[:, None], out_h[:, :-1]], axis=1)
            fu = np.concatenate([top_f[:, None], out_f[:, :-1]], axis=1)
            pv = pv_next
            pv_next = P[nsym[..., None], t[:, None] * R + np.arange(R)]
            use_sym = nsym
            j = s - t
            act = (j >= 0) & (j < n[:, None])  # (B, G)
            gd = gdiag
            gu = _wrap32(hu - go)
            gdiag = np.where(act, gu, gdiag)
            f = fu
            code = np.zeros((B, G, R), np.int64)
            for r in range(R):
                ee = _wrap32(E[..., r] - ge)
                eo = Gr[..., r] >= ee
                e = np.maximum(Gr[..., r], ee)
                dg = _wrap32(gd + go + pv[..., r])
                p1 = dg >= e
                m1 = np.maximum(dg, e)
                ffe = _wrap32(f - ge)
                fo = gu >= ffe
                f = np.maximum(_wrap32(hu - go), ffe)
                h = np.maximum(m1, f)
                p2 = m1 >= f
                if clamp:
                    h = np.maximum(h, 0)
                cr = np.where(p2, np.where(p1, 0, 1), 2)
                if clamp:
                    cr = np.where(h == 0, 3, cr)
                code[..., r] = cr + eo * 4 + fo * 8
                gd = Gr[..., r].copy()
                hu = h
                gu = _wrap32(h - go)
                Gr[..., r] = np.where(act, gu, Gr[..., r])
                E[..., r] = np.where(act, e, E[..., r])
            code[:, nv[:, None] <= np.arange(R)] = 0  # rows past the query
            # into the thread's ring slot of column j
            bb, gg = np.nonzero(act)
            ring[bb, j[gg] % G, gg] = code[bb, gg]
            if p < n_pass - 1:  # thread G - 1 writes the pass buffer
                last = act[:, G - 1]
                bh[last, j[G - 1]] = hu[last, G - 1]
                bf[last, j[G - 1]] = f[last, G - 1]
            out_h = np.where(act, hu, out_h)
            out_f = np.where(act, f, out_f)
            # the group stores column s - G + 1 from its ring slots
            col = s - (G - 1)
            bs = np.nonzero((col >= 0) & (col < n))[0][:, None, None]
            ts = np.nonzero(q0 < Qs)[0]
            store[bs, col, rows[ts]] = ring[bs[..., 0], col % G, ts]
    assert not (store == UNWRITTEN).any(), "T1 leaves bytes unwritten"
    return torch.from_numpy(store).transpose(1, 2)[:, :Q]


def walk_tiled_reference(dirs, qes, tes, algorithm, tile=tb.WALK_TILE,
                         stats=None):
    """T2 as its kernel computes it, on the CPU: each pair on its own,
    stepping until it is done or ``LMAX`` steps have run, reading its
    bytes from a tile of ``tile = (rows, columns)`` bytes of T1's ``(B,
    T_pad, Qs)`` layout (`tb.dirs_storage`), loaded where the path
    leaves the tile before (rows from a multiple of 16 with the cell in
    the last 16, the cell in the last column), and from the reference's
    clipped flat index where a gap state stands on row or column 0.  Its
    ops (3 for none, 255 once stored) go out 16 at a time into ``(B,
    LMAX_s)`` bytes with a tail of 255s
    (every byte asserted written); returns the ``(LMAX, B)`` view, ``i``
    and ``j``.  ``stats`` (a dict) counts the tiles the paths leave by
    their top row (``row``), left column (``col``) or both (``corner``),
    E and F runs that cross a tile's edge (``e_run``, ``f_run``) and the
    steps along row or column 0 (``boundary``).
    """
    spec = ALGORITHMS[algorithm]
    TR, TC = tile
    store, Qs = tb.dirs_storage(dirs)
    st_all = store.cpu().numpy()
    B, Qd, T_pad = dirs.shape
    lmax = 2 * (Qd + T_pad) + 4
    lmax_s = tb._round_up_16(lmax)
    cells = Qd * T_pad
    out = np.full((B, lmax_s), UNWRITTEN, np.uint8)
    i_out = np.zeros(B, np.int32)
    j_out = np.zeros(B, np.int32)
    stats = {} if stats is None else stats
    for key in ("row", "col", "corner", "e_run", "f_run", "boundary"):
        stats.setdefault(key, 0)
    for b in range(B):
        i, j = int(qes[b]) + 1, int(tes[b]) + 1
        st = 0
        done = i == 0 and j == 0
        r0 = c0 = None
        ops = []  # the ops not yet stored
        s = 0
        while s < lmax and not done:
            d = 0
            if st != 0 or (i != 0 and j != 0):
                if 1 <= i <= Qd and 1 <= j <= T_pad:
                    r, c = i - 1, j - 1
                    if r0 is None or r < r0 or c < c0:
                        if r0 is not None:
                            kind = ("corner" if r < r0 and c < c0 else
                                    "row" if r < r0 else "col")
                            stats[kind] += 1
                            if st == 1:
                                stats["e_run"] += 1
                            if st == 2:
                                stats["f_run"] += 1
                        r0 = max(0, (r & ~15) + 16 - TR)
                        c0 = max(0, c - TC + 1)
                        t_ = np.zeros((TC, TR), np.uint8)
                        part = st_all[b, c0:c0 + TC, r0:r0 + TR]
                        t_[:part.shape[0], :part.shape[1]] = part
                    d = int(t_[c - c0, r - r0])
                elif cells > 0:
                    idx = min(max((i - 1) * T_pad + (j - 1), 0), cells - 1)
                    rr, cc = divmod(idx, T_pad)
                    d = int(st_all[b, cc, rr])
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
            emit = 3  # none: 255 once stored
            if h_ins or in_e:
                emit = OP_INS
            if h_del or in_f:
                emit = OP_DEL
            diag = h_inner and code == tb.DIR_DIAG
            if diag:
                emit = OP_MATCH
            stats["boundary"] += h_ins or h_del
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
            i, j = i2, j2
            ops.append(emit)
            if len(ops) == 16:
                out[b, s - 15:s + 1] = [255 if o == 3 else o for o in ops]
                ops = []
            s += 1
        if ops:  # the last partial 16, completed with 255
            out[b, s - len(ops):s - len(ops) + 16] = [
                255 if o == 3 else o for o in ops] + [255] * (16 - len(ops))
            s += 16 - len(ops)
        out[b, s:] = 255
        i_out[b], j_out[b] = i, j
    assert not (out == UNWRITTEN).any(), "T2 leaves bytes unwritten"
    return (torch.from_numpy(out).t()[:lmax], torch.from_numpy(i_out),
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
    k = min(Q, 20)
    tgt[0, 5:5 + k] = q[:k]  # a high-scoring stretch
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


#: gap pairs of the emulation tests: the default, ge > go, zero gaps and
#: a negative gap open
EMU_GAPS = [(3, 1), (1, 3), (0, 0), (-1, 2)]
#: T1's emulation at a small walk (R = 2 rows a thread, G <= 4: passes of
#: 8 rows) and at the kernel's (R = 8, G <= 32: passes of 256 rows), with
#: query lengths on either side of one pass and of two (and, at the
#: kernel's, queries of 1, 9 and 17 rows at G = 2, 2 and 4), each walk
#: as (R, max G, query lengths, B, T_pad)
EMU_WALKS = [(2, 4, (7, 8, 9, 15, 16, 17), 4, 32),
             (tb.DIRS_R, tb.DIRS_MAX_G,
              (1, 9, 17, 255, 256, 257, 511, 512, 513), 4, 40)]


@pytest.mark.parametrize("gaps", EMU_GAPS)
@pytest.mark.parametrize("algo", ALGOS)
def test_dir_kernel_emulation_matches_reference(algo, gaps):
    """T1 as its kernel computes it (groups of G threads, R rows a
    thread, passes through the pass buffer, the ``(B, T_pad, Qs)`` stores,
    every byte written) against the reference's scan and the plain
    version, byte for byte.  The reference runs once per walk at the
    longest query: a shorter query's rows are its first rows."""
    for R, max_g, qlens, B, T_pad in EMU_WALKS:
        q, prof, tgt, lens = _batch(11, max(qlens), B=B, T_pad=T_pad)
        want = _ref_dirs(prof, tgt, *gaps, algo)
        for Q in qlens:
            p = torch.from_numpy(np.ascontiguousarray(prof[:Q]))
            args = (p, torch.from_numpy(tgt), *gaps, algo,
                    torch.from_numpy(lens))
            got = dirs_wave_reference(*args, R=R, max_g=max_g).numpy()
            _assert_region_equal(got, want[:, :Q], lens)
            plain = tb.dir_matrix_reference(*args).numpy()
            np.testing.assert_array_equal(got, plain, err_msg=f"Q={Q}")


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


#: T2's tile at the kernel's size and at a small one (16 rows, 8
#: columns) whose edges the paths cross often
WALK_TILES = [tb.WALK_TILE, (16, 8)]


def _walk_case(algo, gaps):
    """Direction bytes, ends and the reference's walk of one batch."""
    q, prof, tgt, lens = _batch(17, 30, B=8, T_pad=128)
    dirs = _ref_dirs(prof, tgt, *gaps, algo)
    qes, tes = _ends(q, tgt, lens, *gaps, algo)
    if algo in ("hw", "ov"):
        qes[3], tes[3] = len(q) - 1, -1  # an end on the j = 0 boundary
    want = [np.array(x) for x in ref_tb._walk_batch_device(
        jnp.asarray(dirs), jnp.asarray(qes), jnp.asarray(tes), algo)]
    return prof, tgt, lens, dirs, qes, tes, want


@pytest.mark.parametrize("gaps", EMU_GAPS)
@pytest.mark.parametrize("algo", ALGOS)
def test_walk_matches_reference(algo, gaps):
    """T2's plain version and its kernel's emulation (at both tiles, on
    the reference's bytes copied into T1's layout and on T1's emulation's
    own buffer) against the reference's device walk: ``buf``, ``i`` and
    ``j``; semi-global ends on column 0 (``te == -1``) included."""
    prof, tgt, lens, dirs, qes, tes, want = _walk_case(algo, gaps)
    t1 = dirs_wave_reference(torch.from_numpy(prof), torch.from_numpy(tgt),
                             *gaps, algo, torch.from_numpy(lens))
    ends = (torch.from_numpy(qes), torch.from_numpy(tes), algo)
    before = tb.plain_calls["traceback_walk"]
    runs = [tb._walk_batch_device(torch.from_numpy(dirs), *ends)]
    for tile in WALK_TILES:
        runs.append(walk_tiled_reference(torch.from_numpy(dirs), *ends,
                                         tile=tile))
        runs.append(walk_tiled_reference(t1, *ends, tile=tile))
    for got in runs:
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


def _gap_case(algo, gaps):
    """`_walk_case` for a batch whose paths hold long gaps: the query is
    ``a + x + c`` (25, 20 and 25 residues), the targets ``a + c`` (20
    query rows deleted, an F run), ``a + y + c`` with ``y`` 20 other
    residues (at most one diagonal in place of 40 gap steps), ``a + c``
    with 20 residues inserted between (an E run), and a random one."""
    rng = np.random.default_rng(29)
    a, x, c, y, z = (rng.integers(0, 20, n).astype(np.uint8)
                     for n in (25, 20, 25, 20, 20))
    q = np.concatenate([a, x, c])
    seqs = [np.concatenate(p) for p in ((a, c), (a, y, c), (a, z, z, c))]
    seqs.append(rng.integers(0, 20, 90).astype(np.uint8))
    T_pad = 128
    tgt = np.zeros((len(seqs), T_pad), np.int32)
    lens = np.array([len(t_) for t_ in seqs], np.int32)
    for b, t_ in enumerate(seqs):
        tgt[b, :len(t_)] = t_
    prof = np.ascontiguousarray(S[q.astype(np.int64)])
    dirs = _ref_dirs(prof, tgt, *gaps, algo)
    qes, tes = _ends(q, tgt, lens, *gaps, algo)
    want = [np.array(v) for v in ref_tb._walk_batch_device(
        jnp.asarray(dirs), jnp.asarray(qes), jnp.asarray(tes), algo)]
    return dirs, qes, tes, want


@pytest.mark.parametrize("algo", ALGOS)
def test_walk_tiles_cover_every_exit(algo):
    """At the small tile, the paths of `test_walk_matches_reference`'s
    batches and of a batch with long gaps (`_gap_case`) leave tiles by the
    top row, the left column and the corner, carry E and F runs across an
    edge, and (nw, hw) walk row or column 0; each walk equal to the
    reference's."""
    stats = {}
    for gaps in EMU_GAPS:
        for dirs, qes, tes, want in (_walk_case(algo, gaps)[3:],
                                     _gap_case(algo, gaps)):
            got = walk_tiled_reference(torch.from_numpy(dirs),
                                       torch.from_numpy(qes),
                                       torch.from_numpy(tes), algo,
                                       tile=WALK_TILES[1], stats=stats)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w)
    for key in ("row", "col", "corner", "e_run", "f_run"):
        assert stats[key] > 0, (key, stats)
    if algo in ("nw", "hw"):
        assert stats["boundary"] > 0, stats


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
