"""Int32 column-sweep DP in plain PyTorch.

Port of ``pyopal_tpu/ops/xla.py`` (`search_block`, l.39).  The sweep
walks target columns in a Python loop (the reference's ``lax.scan``)
and vectorizes each column over queries, query rows and target lanes.
The vertical gap ``F`` inside a column is solved exactly with a prefix
max (``torch.cummax``) through the identity of the affine recurrence

    F[i] = max_{k < i} ( tmp[k] - gap_open - (i-1-k) * min(go, ge) )

(``F[i] = max(H[i-1]-go, F[i-1]-ge)`` with ``H[i-1] = max(tmp[i-1],
F[i-1])`` folds to ``F[i] = max(tmp[i-1]-go, F[i-1]-min(go, ge))``).

Three callers share `sweep_batch`:

- the engine's route for what the kernels do not take (matrices beyond
  +-256 or outside the exact domain, negative gap penalties, 32-letter
  alphabets), through `search`, which counts `launches`;
- the plain versions of the two kernels
  (`pyopal_tpu_torch.ops.ragged.search_flat_reference`,
  `pyopal_tpu_torch.ops.q8.search_flat_q8_reference`), which do not.

Lanes are visited in length order, so the lanes still inside their
target at column ``j`` are a suffix and each column only touches those.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import ALGORITHMS

NEG = -(2**30)  # "minus infinity" clear of int32 wraparound

#: engine-route calls of `search` (not the kernels' plain versions)
launches = 0


def block_row_offsets(bos: torch.Tensor, n_blocks: int, chunk: int):
    """First flat row of every block, from the ``block_of_step`` map.

    Works on the device of ``bos`` without a host round trip.
    """
    steps = torch.arange(bos.shape[0], device=bos.device, dtype=torch.int32)
    off = torch.zeros(n_blocks, dtype=torch.int32, device=bos.device)
    return off.scatter_reduce_(
        0, bos.long(), steps * chunk, "amin", include_self=False
    )


def flat_index(lengths, bos, chunk, total_rows):
    """``(T_max, n_blocks * lanes)`` positions in a flat-packed array.

    Entry ``[j, n]`` is the offset, in the flattened ``(total_rows,
    lanes)`` array, of column ``j`` of the target of block ``n //
    lanes``, lane ``n % lanes``; past a target's length it is clamped
    into the array and names some other position.
    """
    n_blocks, _, lanes = lengths.shape
    lens = lengths.reshape(-1)
    t_max = int(lens.max()) if lens.numel() else 0
    n = lens.shape[0]
    dev = lengths.device
    if t_max == 0 or n == 0:
        return torch.zeros((0, n), dtype=torch.int64, device=dev)
    row_off = block_row_offsets(bos, n_blocks, chunk)
    lane_ids = torch.arange(n, device=dev)
    base = row_off.long()[lane_ids // lanes]
    rows = torch.arange(t_max, device=dev)[:, None] + base[None, :]
    rows = rows.clamp_(max=total_rows - 1)
    return rows * lanes + (lane_ids % lanes)[None, :]


def columns_from_flat(flat_targets, lengths, bos, chunk):
    """``(T_max, n_blocks * lanes)`` symbol matrix of a flat pack.

    Column ``n`` holds the target of block ``n // lanes``, lane
    ``n % lanes``; rows past a target's length hold arbitrary symbols
    (the sweep never reads them).
    """
    idx = flat_index(lengths, bos, chunk, flat_targets.shape[0])
    return flat_targets.reshape(-1)[idx]


def sweep_batch(profs, qlens, targets, lengths, go, ge, algorithm):
    """Score + end locations of every query against every lane.

    Arguments:
        profs: ``(n_q, R, A)`` int32 profiles, ``profs[q, i, a] =
            S[query_q[i], a]`` for ``i < qlens[q]``; rows past a
            query's length may hold anything.
        qlens: ``(n_q,)`` query lengths, each in ``[0, R]``.
        targets: ``(T, N)`` integer symbols, lane ``n`` in column ``n``.
        lengths: ``(N,)`` target lengths, each ``<= T``.
        go / ge: gap open / extend penalties.
        algorithm: ``nw`` / ``hw`` / ``ov`` / ``sw``.

    Returns:
        ``(scores, query_end, target_end)``, int32 tensors of shape
        ``(n_q, N)`` on the device of ``profs``, with the reference
        `search_block` semantics (0-based ends, -1 = empty).  A query of
        length 0 keeps its empty-target values (the q8 kernel's empty
        slots).
    """
    spec = ALGORITHMS[algorithm]
    dev = profs.device
    i32 = torch.int32
    n_q, R, _ = profs.shape
    N = lengths.shape[0]
    go, ge = int(go), int(ge)
    gmin = min(go, ge)

    lens_h = lengths.cpu().numpy().astype(np.int64)
    order = np.argsort(lens_h, kind="stable")
    sorted_lens = lens_h[order]
    t_max = int(sorted_lens[-1]) if N else 0
    first_active = np.searchsorted(sorted_lens, np.arange(t_max), "right")
    perm = torch.as_tensor(order, device=dev)
    lens = torch.as_tensor(sorted_lens, device=dev).to(i32)
    tgt = targets[:, perm] if t_max else targets

    Q = torch.as_tensor(qlens, device=dev).to(i32).clamp(0, R)  # (n_q,)
    Qv = Q[:, None]  # (n_q, 1)
    has_rows = Qv > 0
    rows = torch.arange(R + 1, device=dev, dtype=i32)[None, :, None]
    valid_row = rows[:, 1:] <= Q[:, None, None]  # (n_q, R, 1)

    if spec.penalize_first_col:
        col0 = torch.where(rows > 0, -(go + (rows - 1) * ge), 0).to(i32)
        empty = -(go + (Qv - 1) * ge)  # H[Q][0], also for Q = 0
    else:
        col0 = torch.zeros_like(rows)
        empty = torch.zeros_like(Qv)
    H = col0.expand(n_q, R + 1, N).clone()
    E = torch.full((n_q, R + 1, N), NEG, dtype=i32, device=dev)

    zero = torch.zeros((n_q, N), dtype=i32, device=dev)
    if spec.track_last_row:
        best = (zero + empty).to(i32)
    else:
        best = torch.full_like(zero, NEG)
    bi = zero.clone()
    bj = zero.clone()
    nw_score = (zero + empty).to(i32)
    lc_best = torch.where(lens[None, :] == 0, 0, NEG).to(i32).expand(n_q, N)
    lc_best = lc_best.clone()
    lc_i = torch.ones_like(zero)
    r_iota = torch.arange(1, R + 1, device=dev, dtype=i32)[None, :, None]
    q_idx = Q.long()[:, None, None]

    for j0 in range(t_max):
        k = int(first_active[j0])
        j = j0 + 1  # 1-based DP column
        sym = tgt[j0, k:].long()
        prof_col = profs.index_select(2, sym)  # (n_q, R, n_act)
        Hs = H[:, :, k:]
        E_new = torch.maximum(Hs - go, E[:, :, k:] - ge)
        row0 = -(go + (j - 1) * ge) if spec.penalize_first_row else 0
        tmp = torch.maximum(Hs[:, :-1] + prof_col, E_new[:, 1:])
        if spec.clamp_zero:
            tmp.clamp_(min=0)
        tmp_full = torch.cat(
            [torch.full_like(tmp[:, :1], row0), tmp], dim=1
        )
        cmax = torch.cummax(tmp_full + rows * gmin, dim=1).values
        F_rows = cmax[:, :-1] - go - rows[:, :-1] * gmin
        H_rows = torch.maximum(tmp, F_rows)
        H[:, 1:, k:] = H_rows
        H[:, 0, k:] = row0
        E[:, :, k:] = E_new
        at_end = (lens[k:] == j)[None, :]

        if spec.track_all_cells or spec.track_last_col:
            masked = torch.where(valid_row, H_rows, NEG)
            colmax = masked.max(dim=1).values  # (n_q, n_act)
            coli = torch.where(
                masked == colmax[:, None, :], r_iota, R + 1
            ).amin(dim=1)
        if spec.track_all_cells:
            upd = colmax > best[:, k:]
            best[:, k:] = torch.where(upd, colmax, best[:, k:])
            bi[:, k:] = torch.where(upd, coli, bi[:, k:])
            bj[:, k:] = torch.where(upd, j, bj[:, k:])
        if spec.track_last_row or spec.track_terminal:
            rowval = H[:, :, k:].gather(
                1, q_idx.expand(n_q, 1, H.shape[2] - k)
            )[:, 0]
        if spec.track_last_row:
            upd = has_rows & (rowval > best[:, k:])
            best[:, k:] = torch.where(upd, rowval, best[:, k:])
            bj[:, k:] = torch.where(upd, j, bj[:, k:])
        if spec.track_terminal:
            nw_score[:, k:] = torch.where(
                has_rows & at_end, rowval, nw_score[:, k:]
            )
        if spec.track_last_col:
            lc_best[:, k:] = torch.where(at_end, colmax, lc_best[:, k:])
            lc_i[:, k:] = torch.where(at_end, coli, lc_i[:, k:])

    lens_q = lens[None, :].expand(n_q, N)
    qlast = (Qv - 1).expand(n_q, N)
    if spec.track_terminal:  # nw
        out = (nw_score, qlast, lens_q - 1)
    elif spec.track_all_cells:  # sw
        empty_aln = best <= 0
        out = (
            torch.where(empty_aln, 0, best),
            torch.where(empty_aln, -1, bi - 1),
            torch.where(empty_aln, -1, bj - 1),
        )
    elif spec.track_last_col:  # ov: row optimum wins ties
        use_col = lc_best > best
        out = (
            torch.maximum(best, lc_best),
            torch.where(use_col, lc_i - 1, qlast),
            torch.where(use_col, lens_q - 1, bj - 1),
        )
    else:  # hw
        out = (best, qlast, bj - 1)

    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(N, device=dev)
    return tuple(x.to(i32)[:, inv] for x in out)


def sweep_all_rows(profs, qlens, targets, lengths, go, ge, algorithm,
                   with_ends):
    """Score + end locations over every profile row, pad rows included.

    The plain version of the kernels that walk all ``R`` rows of their
    profiles as their TPU kernels do (K4, K5, K6): rows past a query's
    length score what the profile holds there (``PAD_SCORE``), and sw's
    best cell and ov's last-column maximum range over them; hw, ov and nw
    read the query's last row at ``Q - 1``.  Ties go to the larger score,
    then the lower column, then the lower row.  In score mode the end
    planes hold what those kernels' finalize writes from untracked
    positions: nw ``Q - 1`` and ``len - 1``, hw ``Q - 1`` and -1, ov
    ``Q - 1`` and -1 or -1 and ``len - 1``, sw -1 and -1.

    Arguments:
        profs: ``(n_q, R, A)`` int32 profiles.
        qlens: ``(n_q,)`` query lengths, each in ``[1, R]``.
        targets / lengths: ``(T, N)`` symbols and ``(N,)`` lengths, as
            `sweep_batch` takes them.

    Returns:
        ``(scores, query_end, target_end)``, int32 of shape ``(n_q, N)``.

    A column sweep vectorized over queries, rows and the lanes still
    inside their target; the vertical gap follows the identity of the
    module docstring, with the closed-form row above the query as the
    prefix max's first term.
    """
    spec = ALGORITHMS[algorithm]
    dev = profs.device
    i32 = torch.int32
    go, ge = int(go), int(ge)
    gmin = min(go, ge)
    n_q, R, _ = profs.shape
    N = lengths.shape[0]

    lens_h = lengths.cpu().numpy().astype(np.int64)
    order = np.argsort(lens_h, kind="stable")
    sorted_lens = lens_h[order]
    t_max = int(sorted_lens[-1]) if N else 0
    first_active = np.searchsorted(sorted_lens, np.arange(t_max), "right")
    perm = torch.as_tensor(order, device=dev)
    lens = torch.as_tensor(sorted_lens, device=dev).to(i32)
    tgt = targets[:t_max, perm].long()
    Q = torch.as_tensor(qlens, device=dev).to(torch.int64).reshape(n_q, 1)
    last = (Q - 1)[:, :, None]  # (n_q, 1, 1) row index for `gather`

    r = torch.arange(R + 1, device=dev, dtype=i32)[:, None]
    rows = r[:-1]
    if spec.penalize_first_col:
        H = -(go + rows * ge)
        empty = -(go + (Q - 1) * ge)  # (n_q, 1)
    else:
        H = torch.zeros_like(rows)
        empty = torch.zeros_like(Q)
    H = H.to(i32).expand(n_q, R, N).clone()
    E = torch.full((n_q, R, N), NEG, dtype=i32, device=dev)

    def full(v):
        return (torch.zeros((n_q, N), dtype=i32, device=dev) + v).to(i32)

    best = full(empty if algorithm == "hw" else 0)
    cap = full(empty if algorithm == "nw" else NEG)
    bi, bj, ci = full(-1), full(-1), full(-1)

    for j in range(t_max):
        k = int(first_active[j])
        if spec.penalize_first_row:
            row0_prev = 0 if j == 0 else -(go + (j - 1) * ge)
            row0_cur = -(go + j * ge)
        else:
            row0_prev = row0_cur = 0
        Hs = H[:, :, k:]
        E_new = torch.maximum(Hs - go, E[:, :, k:] - ge)
        above = torch.cat([torch.full_like(Hs[:, :1], row0_prev), Hs[:, :-1]],
                          dim=1)
        tmp = torch.maximum(above + profs.index_select(2, tgt[j, k:]), E_new)
        if spec.clamp_zero:
            tmp.clamp_(min=0)
        # F[i] = max(row0 - go - i*gmin, max_{m < i} tmp[m] - go
        #            - (i-1-m)*gmin)
        tmp_full = torch.cat([torch.full_like(tmp[:, :1], row0_cur), tmp],
                             dim=1)
        cmax = torch.cummax(tmp_full + r * gmin, dim=1).values
        F = cmax[:, :-1] - go - rows * gmin
        H_new = torch.maximum(tmp, F)
        H[:, :, k:] = H_new
        E[:, :, k:] = E_new

        at_end = lens[k:] == j + 1
        if spec.track_all_cells or spec.track_last_col:
            colmax = H_new.max(dim=1).values
            coli = torch.where(H_new == colmax[:, None], rows, R).amin(1)
            coli = coli.to(i32)
        if spec.track_last_row or spec.track_terminal:
            rowval = H_new.gather(1, last.expand(n_q, 1, N - k))[:, 0]
        if spec.track_all_cells:  # sw
            upd = colmax > best[:, k:]
            best[:, k:] = torch.where(upd, colmax, best[:, k:])
            if with_ends:
                bi[:, k:] = torch.where(upd, coli, bi[:, k:])
                bj[:, k:] = torch.where(upd, j, bj[:, k:])
        if spec.track_last_row:  # hw / ov
            upd = rowval > best[:, k:]
            best[:, k:] = torch.where(upd, rowval, best[:, k:])
            if with_ends:
                bj[:, k:] = torch.where(upd, j, bj[:, k:])
        if spec.track_terminal:  # nw
            cap[:, k:] = torch.where(at_end, rowval, cap[:, k:])
        if spec.track_last_col:  # ov
            cap[:, k:] = torch.where(at_end, colmax, cap[:, k:])
            if with_ends:
                ci[:, k:] = torch.where(at_end, coli, ci[:, k:])

    qlast = full(Q - 1)
    tlast = (lens - 1).expand(n_q, N)
    if algorithm == "sw":
        hit = best > 0
        out = (best, torch.where(hit, bi, -1), torch.where(hit, bj, -1))
    elif algorithm == "nw":
        out = (cap, qlast, tlast)
    elif algorithm == "hw":
        out = (best, qlast, bj)
    else:  # ov: ties go to the last-row end
        use_col = cap > best
        out = (
            torch.maximum(best, cap),
            torch.where(use_col, ci, qlast),
            torch.where(use_col, tlast, bj),
        )
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(N, device=dev)
    return tuple(x.to(i32)[:, inv] for x in out)


def search_block(prof_t, targets, lengths, go, ge, algorithm):
    """Port of the reference `search_block`: one query, one block.

    ``prof_t`` is the ``(Q, A)`` int32 profile, ``targets`` the
    ``(T_pad, B)`` symbols and ``lengths`` the ``(B,)`` lengths; returns
    ``(scores, query_end, target_end)`` of shape ``(B,)``.
    """
    s, qe, te = sweep_batch(
        prof_t[None], [prof_t.shape[0]], targets, lengths, go, ge, algorithm
    )
    return s[0], qe[0], te[0]


def search(profs, qlens, targets, lengths, go, ge, algorithm):
    """The engine's sweep route: `sweep_batch`, counted in `launches`."""
    global launches
    launches += 1
    return sweep_batch(profs, qlens, targets, lengths, go, ge, algorithm)


def make_profile_t(query_enc: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Build the ``(Q, A)`` transposed query profile (int32)."""
    S = np.asarray(matrix, dtype=np.int32)
    q = np.asarray(query_enc, dtype=np.int64)
    return S[q, :]
