"""Plain reference for Opal's four algorithms, scores and end positions,
in PyTorch and int32, independent of the program.

Affine gaps in Opal's convention: a gap of ``N`` residues costs
``gap_open + (N - 1) * gap_extend``.  For query row ``i`` (1..Q) and
target column ``j`` (1..T)::

    E[i][j] = max(E[i][j-1] - ge, H[i][j-1] - go)
    F[i][j] = max(F[i-1][j] - ge, H[i-1][j] - go)
    H[i][j] = max(H[i-1][j-1] + S[q_i][t_j], E[i][j], F[i][j])
              (and at least 0 for sw)

with ``E[i][0] = F[0][j] = -inf`` and each algorithm's first row
``H[0][j]`` and first column ``H[i][0]`` (``i, j >= 1``; ``H[0][0] = 0``):

=========  ======================  ======================  =============================
algorithm  ``H[0][j]``             ``H[i][0]``             score
=========  ======================  ======================  =============================
``nw``     ``-(go + (j-1) ge)``    ``-(go + (i-1) ge)``    ``H[Q][T]``
``hw``     0                       ``-(go + (i-1) ge)``    ``max_{j>=0} H[Q][j]``
``ov``     0                       0                       that, or ``max_i H[i][T]``
``sw``     0                       0                       ``max_{i,j} H[i][j]``
=========  ======================  ======================  =============================

End positions are 0-based query and target residues.  The sweep order
decides them, target position first, then query position: the first
strict optimum wins.  For ``ov`` a last-row optimum beats an equal
last-column one; ``sw`` with score 0 ends at ``(-1, -1)``; ``nw`` ends
at ``(Q-1, T-1)``; an ``hw``/``ov`` optimum at ``j = 0`` has target end
``-1``.

The structure is `reference.sw_scores`': one loop over target columns,
with every target of a block and every row of every query in one
tensor, each query's rows after one separator row, and a column's
vertical gaps from one prefix maximum over its rows.  Where the
derivation differs from ``sw``'s:

1. There is no clamp at 0 but for ``sw``.  So the separator rows, which
   stand for the first row ``H[0][j]``, are assigned its value at every
   column (``sw``'s hold 0 through the clamp).  That value enters the
   column's prefix maximum, which gives ``F[1][j] = H[0][j] - go``, and
   the next column's diagonal.
2. The state before the first column is the first column ``H[i][0]``,
   penalized for ``nw`` and ``hw`` (``sw``'s is 0).
3. ``H`` can be negative.  Each query's offset ``segment * BIG`` covers
   the whole range ``[-M, M]``, ``M = (Q + T) * max(|S|, go)`` (a path
   has at most ``Q + T`` steps, none worth more than that), where
   ``sw``'s covers ``[0, M]``: the separator's term then stays above
   every earlier query's.
4. Taking ``H'``, ``H`` before the vertical gap, for ``H`` in the prefix
   maximum gives the same ``F`` whenever ``go >= ge >= 0``, with the
   clamp or without: a gap opened below a cell whose value came from a
   vertical gap is never better than extending that gap.
5. The score is read where the algorithm says, and trackers keep the
   ends: for ``sw`` each row's best value and the first column that
   reached it; for ``hw`` and ``ov`` the last row's running best from
   ``j = 0``; for ``ov`` also the last column, from the final state (a
   target's rows freeze after its last column); for ``nw`` the final
   state's last row.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

ALGORITHMS = ("nw", "hw", "ov", "sw")


def search(
    queries,
    db_codes,
    db_offsets,
    db_lengths,
    targets,
    matrix,
    gap_open: int,
    gap_extend: int,
    *,
    algorithm: str,
    ends: bool,
    device,
    block_cells: int = 1 << 27,
) -> np.ndarray:
    """Scores, and with ``ends`` end positions, of every query against
    every target in ``targets``.

    The arguments are `reference.sw_scores`': ``queries`` a list of
    uint8 code arrays of one residue or more, ``db_codes`` the
    concatenated database codes (host array) with ``db_offsets`` and
    ``db_lengths`` per target, ``targets`` the database indices,
    ``matrix`` the substitution table indexed by code.  Returns an int32
    array of planes ``(P, n_queries, len(targets))``: the scores, and
    with ``ends`` the query ends and the target ends (``P = 3``).
    """
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm: {algorithm!r}")
    go, ge = int(gap_open), int(gap_extend)
    if not 0 <= ge <= go:
        raise ValueError("the reference needs gap_open >= gap_extend >= 0")
    S = np.asarray(matrix, dtype=np.int64)
    targets = np.asarray(targets, dtype=np.int64)
    out = np.zeros((3 if ends else 1, len(queries), targets.shape[0]), np.int32)
    if not len(queries) or not targets.shape[0]:
        return out
    tlen = np.asarray(db_lengths, dtype=np.int64)[targets]
    qlens = np.array([len(q) for q in queries], dtype=np.int64)
    if qlens.min() < 1:
        raise ValueError("the reference needs queries of one residue or more")
    sw, nq = algorithm == "sw", len(queries)

    # stacked rows: a separator (DP row 0 of each segment), then the query
    seg_len = qlens + 1
    R = int(seg_len.sum())
    seg = np.repeat(np.arange(nq), seg_len)
    seg_start = np.concatenate(([0], np.cumsum(seg_len)[:-1]))
    last = seg_start + qlens  # DP row Q of each query
    loc = np.arange(R) - seg_start[seg]  # 0 on separators
    sep = loc == 0
    m = (int(qlens.max()) + int(tlen.max())) * max(int(np.abs(S).max()), go, 1)
    big = 2 * m + (int(qlens.max()) + 1) * ge + 1
    if (nq + 1) * big >= 1 << 29:
        raise ValueError("too many query rows for the int32 offsets")
    neg = 1 << 30
    prof = np.full((S.shape[1], R), -neg // 4, dtype=np.int64)
    rows = np.nonzero(~sep)[0]
    qcat = np.concatenate([np.asarray(q, dtype=np.int64) for q in queries])
    prof[:, rows] = S[qcat].T
    off = loc * ge + seg * big
    K = go + (loc - 1) * ge + seg * big
    K[sep] = neg
    col0 = np.zeros(R, dtype=np.int64)
    if algorithm in ("nw", "hw"):
        col0[~sep] = -(go + (loc[~sep] - 1) * ge)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32).to(device)

    prof_t, off_t, K_t, col0_t = dev(prof), dev(off), dev(K), dev(col0)
    sep_t = torch.as_tensor(seg_start).to(device)
    last_t = torch.as_tensor(last).to(device)

    order = np.argsort(-tlen, kind="stable")
    block = max(1, block_cells // R)
    codes = np.asarray(db_codes)
    offsets = np.asarray(db_offsets, dtype=np.int64)[targets]
    for b0 in range(0, order.shape[0], block):
        idx = order[b0 : b0 + block]
        lens = tlen[idx]
        L, n0 = int(lens[0]), idx.shape[0]
        # (L, n) target codes, column j contiguous; alive[j] = targets
        # longer than j, a prefix since lengths fall
        cols = np.zeros((L, n0), dtype=np.int64)
        for k, (o, n) in enumerate(zip(offsets[idx], lens)):
            cols[:n, k] = codes[o : o + n]
        cols_t = torch.as_tensor(cols).to(device)
        alive = np.searchsorted(-lens, -np.arange(L), side="left")
        H = col0_t.expand(n0, R).clone()
        E = torch.full((n0, R), -neg, dtype=torch.int32, device=device)
        if sw:
            best = torch.zeros((n0, R), dtype=torch.int32, device=device)
            bcol = (
                torch.full((n0, R), -1, dtype=torch.int32, device=device)
                if ends else None
            )
        else:
            # the last row's running best from j = 0, and its column
            lbest = H.index_select(1, last_t)
            lcol = torch.full((n0, nq), -1, dtype=torch.int32, device=device)
        for j in range(L):
            n = int(alive[j])
            h, e = H[:n], E[:n]
            s = prof_t.index_select(0, cols_t[j, :n])
            diag = F.pad(h[:, :-1], (1, 0))
            torch.maximum(e - ge, h - go, out=e)
            hp = torch.maximum(diag + s, e)
            if sw:
                hp.clamp_(min=0)
            else:
                hp[:, sep_t] = -(go + j * ge) if algorithm == "nw" else 0
            c = torch.cummax(hp + off_t, dim=1).values
            f = F.pad(c[:, :-1], (1, 0)) - K_t
            hn = torch.maximum(hp, f)
            h.copy_(hn)
            if sw:
                if ends:
                    bcol[:n].masked_fill_(hn > best[:n], j)
                torch.maximum(best[:n], hn, out=best[:n])
            else:
                hl = hn.index_select(1, last_t)
                if ends:
                    lcol[:n].masked_fill_(hl > lbest[:n], j)
                torch.maximum(lbest[:n], hl, out=lbest[:n])
        planes = _read_out(
            algorithm, ends, H, best if sw else lbest, bcol if sw else lcol,
            seg_start, qlens, lens, device,
        )
        out[:, :, b0 : b0 + n0] = planes.cpu().numpy()
        del H, E, cols_t
    # columns were filled in length order; put them back in target order
    result = np.empty_like(out)
    result[:, :, order] = out
    return result


def _first_best(v, key):
    """Each row's largest value of ``v`` ``(n, Q)`` and, among the
    positions holding it, the one of least ``key`` (int64, distinct)."""
    top = v.amax(1)
    pick = torch.where(v == top[:, None], key, torch.iinfo(torch.int64).max)
    return top, pick.amin(1)


def _read_out(algorithm, ends, H, best, col, seg_start, qlens, lens, device):
    """The block's ``(P, n_queries, n)`` planes from its final state and
    trackers; ``H`` holds each target's last column."""
    n0, nq = H.shape[0], len(qlens)
    scores = torch.empty((nq, n0), dtype=torch.int32, device=device)
    q_end = torch.empty_like(scores)
    t_end = torch.empty_like(scores)
    t_last = torch.as_tensor(lens - 1, dtype=torch.int32, device=device)
    for q in range(nq):
        a, Q = int(seg_start[q]) + 1, int(qlens[q])
        i = torch.arange(Q, dtype=torch.int64, device=device)
        if algorithm == "sw" and not ends:
            scores[q] = best[:, a : a + Q].amax(1)
        elif algorithm == "sw":
            # sweep order: the first column reaching the best, then the row
            key = col[:, a : a + Q].to(torch.int64) * (Q + 1) + i
            top, k = _first_best(best[:, a : a + Q], key)
            hit = top > 0
            scores[q] = top
            q_end[q] = torch.where(hit, k % (Q + 1), -1).to(torch.int32)
            t_end[q] = torch.where(hit, k // (Q + 1), -1).to(torch.int32)
        elif algorithm == "nw":
            scores[q] = H[:, a + Q - 1]
            q_end[q] = Q - 1
            t_end[q] = t_last
        else:
            scores[q] = best[:, q]
            q_end[q] = Q - 1
            t_end[q] = col[:, q]
            if algorithm == "ov":
                # the last column, first row first, beats the last row
                # only when strictly better
                top, k = _first_best(H[:, a : a + Q], i.expand(n0, Q))
                take = top > best[:, q]
                scores[q] = torch.where(take, top, best[:, q])
                q_end[q] = torch.where(take, k.to(torch.int32), Q - 1)
                t_end[q] = torch.where(take, t_last, col[:, q])
    if not ends:
        return scores[None]
    return torch.stack((scores, q_end, t_end))
