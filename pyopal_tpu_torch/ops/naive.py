"""Scalar numpy oracle: exact DP with traceback, one pair at a time.

Port of ``pyopal_tpu/ops/naive.py``, copied unchanged: the ground truth
the port's tests and ``chip_smoke.py`` check the kernels against.

This is the ground-truth implementation of the recurrence in
`pyopal_tpu.models.specs` — deliberately simple (full ``(Q+1, T+1)``
matrices, no vectorization tricks) so the vectorized XLA engine and the
Pallas TPU kernel can be validated against it.  It also serves as the
traceback engine for ``mode="full"`` until the batched on-device
traceback lands (reference analog: the pairwise alignment recompute
Opal performs after the SIMD score pass [upstream], see
upstream PyOpal ``src/pyopal/opal.pxd:17-19`` search levels).

Tie-breaking rules (fixed, documented):

- end location: maxima are taken in sweep order (increasing target
  position ``j``, then increasing query position ``i``) with strict
  improvement, i.e. the *first* optimum encountered wins;
- for ``ov``, a last-row optimum is preferred over an equal last-column
  optimum;
- traceback prefers diagonal moves, then gaps in the query (target
  residue unmatched), then gaps in the target — this reproduces the
  reference CIGAR ``1D5M1D1M`` for the pinned NW example
  (upstream PyOpal ``src/pyopal/lib.pyx:1005-1010``).
"""

from __future__ import annotations

import numpy as np

from ..models import ALGORITHMS
from ..results import OP_DEL, OP_INS, OP_MATCH, OP_MISMATCH

NEG_INF = np.int64(-(2**40))  # sentinel; int64 math avoids any wraparound


def _boundaries(spec, Q, T, go, ge):
    """First row / first column of H per the algorithm spec."""
    row0 = np.zeros(T + 1, dtype=np.int64)
    col0 = np.zeros(Q + 1, dtype=np.int64)
    if spec.penalize_first_row and T > 0:
        row0[1:] = -(go + np.arange(T, dtype=np.int64) * ge)
    if spec.penalize_first_col and Q > 0:
        col0[1:] = -(go + np.arange(Q, dtype=np.int64) * ge)
    return row0, col0


def dp_matrices(query, target, matrix, go, ge, algorithm):
    """Compute full H/E/F matrices (int64). Returns (H, E, F)."""
    spec = ALGORITHMS[algorithm]
    q = np.asarray(query, dtype=np.int64)
    t = np.asarray(target, dtype=np.int64)
    S = np.asarray(matrix, dtype=np.int64)
    Q, T = q.shape[0], t.shape[0]

    H = np.zeros((Q + 1, T + 1), dtype=np.int64)
    E = np.full((Q + 1, T + 1), NEG_INF, dtype=np.int64)
    F = np.full((Q + 1, T + 1), NEG_INF, dtype=np.int64)
    row0, col0 = _boundaries(spec, Q, T, go, ge)
    H[0, :] = row0
    H[:, 0] = col0

    for i in range(1, Q + 1):
        for j in range(1, T + 1):
            E[i, j] = max(H[i, j - 1] - go, E[i, j - 1] - ge)
            F[i, j] = max(H[i - 1, j] - go, F[i - 1, j] - ge)
            h = max(H[i - 1, j - 1] + S[q[i - 1], t[j - 1]], E[i, j], F[i, j])
            if spec.clamp_zero and h < 0:
                h = 0
            H[i, j] = h
    return H, E, F


def score_end(query, target, matrix, go, ge, algorithm):
    """Score + end locations (0-based residue coordinates).

    Returns ``(score, query_end, target_end)``; ends are ``-1`` when the
    optimum is on a boundary (empty alignment).
    """
    spec = ALGORITHMS[algorithm]
    H, _, _ = dp_matrices(query, target, matrix, go, ge, algorithm)
    Q, T = H.shape[0] - 1, H.shape[1] - 1

    if spec.track_terminal:
        return int(H[Q, T]), Q - 1, T - 1

    if spec.track_all_cells:  # sw: sweep order j outer, i inner
        best, bi, bj = -(2**62), 0, 0
        for j in range(1, T + 1):
            col = H[1:, j]
            m = int(col.max()) if Q else 0
            if m > best:
                best, bj = m, j
                bi = int(col.argmax()) + 1 if Q else 0
        if T == 0 or Q == 0 or best <= 0:
            # an empty local alignment has score 0 and no end location
            return max(best, 0), -1, -1
        return best, bi - 1, bj - 1

    # hw / ov: max over last row (including the j=0 full-overhang end),
    # first j wins
    best, bi, bj = int(H[Q, 0]), Q, 0
    if spec.track_last_row:
        for j in range(1, T + 1):
            if int(H[Q, j]) > best:
                best, bj = int(H[Q, j]), j
    if spec.track_last_col:
        for i in range(1, Q + 1):
            if int(H[i, T]) > best:
                best, bi, bj = int(H[i, T]), i, T
    return best, bi - 1, bj - 1


def traceback(query, target, matrix, go, ge, algorithm):
    """Full alignment: (score, q_start, t_start, q_end, t_end, ops).

    ``ops`` is a ``uint8`` array over {M=0, D=1, I=2, X=3} — D consumes a
    query residue (gap in target), I consumes a target residue (gap in
    query), matching the reference op constants (``lib.pyx:97-102``).
    """
    spec = ALGORITHMS[algorithm]
    q = np.asarray(query, dtype=np.int64)
    t = np.asarray(target, dtype=np.int64)
    S = np.asarray(matrix, dtype=np.int64)
    H, E, F = dp_matrices(query, target, matrix, go, ge, algorithm)
    score, qe, te = score_end(query, target, matrix, go, ge, algorithm)

    i, j = qe + 1, te + 1
    ops = []
    state = "H"
    while i > 0 or j > 0:
        if state == "H":
            h = H[i, j]
            if spec.clamp_zero and h == 0:
                break  # sw: local alignment start
            if i > 0 and j > 0 and h == H[i - 1, j - 1] + S[q[i - 1], t[j - 1]]:
                ops.append(OP_MATCH if q[i - 1] == t[j - 1] else OP_MISMATCH)
                i -= 1
                j -= 1
                continue
            if i == 0:
                if spec.penalize_first_row:
                    ops.append(OP_INS)
                    j -= 1
                    continue
                break  # free leading target overhang: alignment starts here
            if j == 0:
                if spec.penalize_first_col:
                    ops.append(OP_DEL)
                    i -= 1
                    continue
                break
            if j > 0 and h == E[i, j]:
                state = "E"
                continue
            if i > 0 and h == F[i, j]:
                state = "F"
                continue
            raise AssertionError("inconsistent DP matrices")
        elif state == "E":
            ops.append(OP_INS)
            if E[i, j] == H[i, j - 1] - go:
                state = "H"
            j -= 1
        else:  # state == "F"
            ops.append(OP_DEL)
            if F[i, j] == H[i - 1, j] - go:
                state = "H"
            i -= 1

    qs, ts = i, j
    ops_arr = np.array(ops[::-1], dtype=np.uint8)
    return int(score), qs, ts, qe, te, ops_arr
