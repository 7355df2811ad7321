"""Declarative specifications of the four alignment algorithms.

Port of ``pyopal_tpu/models/specs.py``, copied unchanged.

All four algorithms share one affine-gap recurrence over the
``(Q+1) x (T+1)`` DP matrix ``H`` with gap matrices ``E`` (gap in the
query, advancing along the target) and ``F`` (gap in the target,
advancing along the query)::

    E[i][j] = max(H[i][j-1] - gap_open, E[i][j-1] - gap_extend)
    F[i][j] = max(H[i-1][j] - gap_open, F[i-1][j] - gap_extend)
    H[i][j] = max(H[i-1][j-1] + S(q[i-1], t[j-1]), E[i][j], F[i][j])
              (clamped to >= 0 for the local algorithm)

so a gap of length N costs ``gap_open + (N-1) * gap_extend``
(reference docstring, upstream PyOpal ``src/pyopal/lib.pyx:1184-1186``,
pinned by the golden scores NW=44 / SW=47 in ``tests/test_aligner.py``).

They differ only in boundary conditions and in where the optimal score
is read:

========= ============== ============== ===========================
algorithm first row       first column   score location
========= ============== ============== ===========================
``nw``    gap-penalized   gap-penalized  ``H[Q][T]``
``hw``    free            gap-penalized  ``max_j H[Q][j]``
``ov``    free            free           ``max_j H[Q][j]``, ``max_i H[i][T]``
``sw``    free (clamp 0)  free (clamp 0) ``max_{i,j} H[i][j]``
========= ============== ============== ===========================

(`hw` = gaps at the *query* edges — i.e. target overhangs — are free;
`ov` = overlap mode, both edges free; reference semantics documented at
``lib.pyx:1290-1295``.)
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AlgorithmSpec:
    """Boundary conditions + score location for one algorithm."""

    name: str
    #: first DP row (query exhausted / target prefix) is gap-penalized
    penalize_first_row: bool
    #: first DP column (target exhausted / query prefix) is gap-penalized
    penalize_first_col: bool
    #: clamp every cell to >= 0 (local alignment)
    clamp_zero: bool
    #: optimal score includes the maximum over the last row (row Q)
    track_last_row: bool
    #: optimal score includes the maximum over the last column (col T)
    track_last_col: bool
    #: optimal score is the maximum over every cell
    track_all_cells: bool
    #: optimal score is the single terminal cell H[Q][T]
    track_terminal: bool


ALGORITHMS = {
    "nw": AlgorithmSpec(
        "nw",
        penalize_first_row=True,
        penalize_first_col=True,
        clamp_zero=False,
        track_last_row=False,
        track_last_col=False,
        track_all_cells=False,
        track_terminal=True,
    ),
    "hw": AlgorithmSpec(
        "hw",
        penalize_first_row=False,
        penalize_first_col=True,
        clamp_zero=False,
        track_last_row=True,
        track_last_col=False,
        track_all_cells=False,
        track_terminal=False,
    ),
    "ov": AlgorithmSpec(
        "ov",
        penalize_first_row=False,
        penalize_first_col=False,
        clamp_zero=False,
        track_last_row=True,
        track_last_col=True,
        track_all_cells=False,
        track_terminal=False,
    ),
    "sw": AlgorithmSpec(
        "sw",
        penalize_first_row=False,
        penalize_first_col=False,
        clamp_zero=True,
        track_last_row=False,
        track_last_col=False,
        track_all_cells=True,
        track_terminal=False,
    ),
}
