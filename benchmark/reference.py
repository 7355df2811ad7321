"""Plain Smith-Waterman reference in PyTorch, independent of the program.

Scores of local alignments with affine gaps in Opal's convention: a gap
of ``N`` residues costs ``gap_open + (N - 1) * gap_extend``.  For query
row ``i`` and target column ``j``::

    E[i][j] = max(E[i][j-1] - ge, H[i][j-1] - go)
    F[i][j] = max(F[i-1][j] - ge, H[i-1][j] - go)
    H[i][j] = max(0, H[i-1][j-1] + S[q_i][t_j], E[i][j], F[i][j])
    score   = max over i, j of H[i][j]

The loop runs over target columns, with every target of a block and
every row of every query in one tensor.  The queries' rows are stacked,
each query after one separator row that always holds 0, and a column's
vertical gaps come from one prefix maximum over the rows: ``F[i] =
max_{k<i}(H'[k] + k*ge) - go - (i-1)*ge``, where ``H'`` is ``H`` before
the vertical gap.  Taking ``H'`` for ``H`` there gives the same ``F``
whenever ``go >= ge >= 0``: a gap opened from a cell whose value came
from a vertical gap is never better than extending that gap.  Each
query's rows carry an offset ``segment * BIG`` so the prefix maximum
never reaches across queries.

``cap`` saturates every ``H`` at that value, as an unsigned 8-bit pass
without Opal's escalation to wider scores does (``cap=255``): the
control of the comparison.  Everything runs in int32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def sw_scores(
    queries,
    db_codes,
    db_offsets,
    db_lengths,
    targets,
    matrix,
    gap_open: int,
    gap_extend: int,
    *,
    device,
    cap: int | None = None,
    block_cells: int = 1 << 27,
) -> np.ndarray:
    """Scores of every query against every target in ``targets``.

    ``queries`` is a list of uint8 code arrays, ``db_codes`` the
    concatenated database codes (host array) with ``db_offsets`` and
    ``db_lengths`` per target, ``targets`` the database indices to
    score, ``matrix`` the substitution table indexed by code.  Returns
    an ``(n_queries, len(targets))`` int32 array.
    """
    go, ge = int(gap_open), int(gap_extend)
    if not 0 <= ge <= go:
        raise ValueError("the reference needs gap_open >= gap_extend >= 0")
    S = np.asarray(matrix, dtype=np.int64)
    targets = np.asarray(targets, dtype=np.int64)
    out = np.zeros((len(queries), targets.shape[0]), dtype=np.int32)
    if not len(queries) or not targets.shape[0]:
        return out
    tlen = np.asarray(db_lengths, dtype=np.int64)[targets]
    qlens = np.array([len(q) for q in queries], dtype=np.int64)

    # stacked rows: a separator (row 0 of each segment), then the query
    seg_len = qlens + 1
    R = int(seg_len.sum())
    seg = np.repeat(np.arange(len(queries)), seg_len)
    seg_start = np.concatenate(([0], np.cumsum(seg_len)[:-1]))
    loc = np.arange(R) - seg_start[seg]  # 0 on separators
    sep = loc == 0
    big = int(np.abs(S).max()) * int(min(qlens.max(), tlen.max())) + (
        int(qlens.max()) + 1
    ) * ge + 1
    if (len(queries) + 1) * big >= 1 << 29:
        raise ValueError("too many query rows for the int32 offsets")
    neg = 1 << 30
    prof = np.full((S.shape[1], R), -neg // 4, dtype=np.int64)
    rows = np.nonzero(~sep)[0]
    qcat = np.concatenate([np.asarray(q, dtype=np.int64) for q in queries])
    prof[:, rows] = S[qcat].T
    off = loc * ge + seg * big
    K = go + (loc - 1) * ge + seg * big
    K[sep] = neg

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32).to(device)

    prof_t, off_t, K_t = dev(prof), dev(off), dev(K)
    bounds = np.concatenate((seg_start, [R]))

    order = np.argsort(-tlen, kind="stable")
    block = max(1, block_cells // R)
    codes = np.asarray(db_codes)
    offsets = np.asarray(db_offsets, dtype=np.int64)[targets]
    for b0 in range(0, order.shape[0], block):
        idx = order[b0 : b0 + block]
        lens = tlen[idx]
        L = int(lens[0])
        if L == 0:
            continue
        # (L, n) target codes, column j contiguous; alive[j] = targets
        # longer than j, a prefix since lengths fall
        cols = np.zeros((L, idx.shape[0]), dtype=np.int64)
        for k, (o, n) in enumerate(zip(offsets[idx], lens)):
            cols[:n, k] = codes[o : o + n]
        cols_t = torch.as_tensor(cols).to(device)
        alive = np.searchsorted(-lens, -np.arange(L), side="left")
        n0 = idx.shape[0]
        H = torch.zeros((n0, R), dtype=torch.int32, device=device)
        E = torch.full((n0, R), -neg, dtype=torch.int32, device=device)
        best = torch.zeros((n0, R), dtype=torch.int32, device=device)
        for j in range(L):
            n = int(alive[j])
            h, e = H[:n], E[:n]
            s = prof_t.index_select(0, cols_t[j, :n])
            diag = F.pad(h[:, :-1], (1, 0))
            torch.maximum(e - ge, h - go, out=e)
            hp = torch.maximum(diag + s, e).clamp_(min=0)
            c = torch.cummax(hp + off_t, dim=1).values
            f = F.pad(c[:, :-1], (1, 0)) - K_t
            hn = torch.maximum(hp, f)
            if cap is not None:
                hn.clamp_(max=cap)
            h.copy_(hn)
            torch.maximum(best[:n], hn, out=best[:n])
        per_query = torch.stack(
            [best[:, bounds[i] : bounds[i + 1]].amax(1) for i in range(len(queries))]
        )
        out[:, b0 : b0 + idx.shape[0]] = per_query.cpu().numpy()
        del H, E, best, cols_t
    # columns were filled in length order; put them back in target order
    result = np.empty_like(out)
    result[:, order] = out
    return result


def sw_score_brute(query, target, matrix, gap_open, gap_extend) -> int:
    """One pair, cell by cell in plain Python: the reference's own check."""
    go, ge = int(gap_open), int(gap_extend)
    Q, T = len(query), len(target)
    ninf = -(1 << 40)
    H = [[0] * (T + 1) for _ in range(Q + 1)]
    E = [[ninf] * (T + 1) for _ in range(Q + 1)]
    Fm = [[ninf] * (T + 1) for _ in range(Q + 1)]
    best = 0
    for i in range(1, Q + 1):
        for j in range(1, T + 1):
            E[i][j] = max(E[i][j - 1] - ge, H[i][j - 1] - go)
            Fm[i][j] = max(Fm[i - 1][j] - ge, H[i - 1][j] - go)
            H[i][j] = max(
                0,
                H[i - 1][j - 1] + int(matrix[query[i - 1]][target[j - 1]]),
                E[i][j],
                Fm[i][j],
            )
            best = max(best, H[i][j])
    return best
