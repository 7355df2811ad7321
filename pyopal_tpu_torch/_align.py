"""Top-level ``align`` generator: chunked multi-threaded database search.

Port of ``pyopal_tpu/_align.py``, with a ``device`` argument passed to
the `Aligner` (``None`` means ``"cuda"``).  Original notes:
API parity with the reference orchestrator signature and semantics
(upstream PyOpal ``src/pyopal/_align.py:28-41``), re-implemented around
this package's packed-database layout:

- ``threads=0`` (the default) is accelerator-first: the
  fastest plan is a *single fused dispatch* over the whole packed
  database (device lanes replace host threads), so ``0`` means "let the
  framework choose" rather than ``os.cpu_count()`` — a documented
  divergence.
- ``threads >= 2`` keeps the reference's thread-pool behavior, but the
  chunk edges are quantized to the packed-lane width (`LANES`): each
  worker's slice covers whole lane blocks, so no packed block is split
  between two kernel launches.  Chunking is invisible in the results —
  scores never depend on the slice and ``target_index`` is always the
  global database index.
"""

from __future__ import annotations

import contextlib
import multiprocessing.pool

from .aligner import Aligner
from .database import BaseDatabase, Database
from .matrices import ScoringMatrix
from .ops.packing import LANES


def _resolve_matrix(scoring_matrix) -> ScoringMatrix:
    """Accept ``None`` (default matrix), a name, or a matrix object."""
    if scoring_matrix is None:
        return Aligner._DEFAULT_SCORING_MATRIX
    if isinstance(scoring_matrix, str):
        return ScoringMatrix.from_name(scoring_matrix)
    if isinstance(scoring_matrix, ScoringMatrix):
        return scoring_matrix
    ty = type(scoring_matrix).__name__
    raise TypeError(f"expected str or ScoringMatrix, got {ty}")


def _chunk_bounds(n_targets: int, n_chunks: int, quantum: int = LANES):
    """Yield ``(start, end)`` slices cutting ``n_targets`` into at most
    ``n_chunks`` runs whose edges fall on ``quantum`` boundaries.

    Lane-aligned edges keep each worker's slice covering whole packed
    blocks, so per-chunk packing never re-pads a partially-owned block.
    """
    n_chunks = max(n_chunks, 1)
    per = -(-n_targets // n_chunks)  # ceil
    per = -(-per // quantum) * quantum  # round up to the lane width
    start = 0
    while start < n_targets:
        end = min(start + per, n_targets)
        yield start, end
        start = end


def align(
    query,
    database,
    scoring_matrix=None,
    *,
    gap_open: int = 3,
    gap_extend: int = 1,
    mode: str = "score",
    overflow: str = "buckets",
    algorithm: str = "sw",
    threads: int = 0,
    pool=None,
    ordered: bool = False,
    device=None,
):
    """Align a query against every database sequence, in parallel.

    Arguments:
        query (`str` or byte-like object): The query sequence.
        database (iterable of `str` or byte-like objects): The target
            sequences; a `~pyopal_tpu_torch.BaseDatabase` is used as-is, any
            other iterable is encoded into a fresh `Database` first.
        scoring_matrix (`~pyopal_tpu_torch.ScoringMatrix` or `str`): The
            scoring matrix, as an object or a bundled-matrix name
            (default: BLOSUM50).

    Keyword Arguments:
        gap_open (`int`): The gap opening penalty.
        gap_extend (`int`): The gap extension penalty.
        mode (`str`): ``score`` (default), ``end`` or ``full``.
        overflow (`str`): ``simple`` or ``buckets`` (API parity; the
            int32 engines cannot overflow).
        algorithm (`str`): ``nw``, ``hw``, ``ov`` or ``sw``.
        threads (`int`): ``0`` (default) runs one fused device search;
            ``1`` searches on the calling thread; ``>= 2`` cuts the
            database into lane-aligned chunks handed to a
            `multiprocessing.pool.ThreadPool`.
        pool (`multiprocessing.pool.ThreadPool`): An existing pool to
            reuse across calls (only consulted when ``threads >= 2``);
            the caller keeps ownership and must close it.
        ordered (`bool`): Yield results in database order instead of
            chunk-completion order.
        device (`str` or `torch.device`): ``"cuda"`` (the default) or
            ``"cpu"``.

    Yields:
        `~pyopal_tpu_torch.ScoreResult`: One result per target sequence, of
        the type matching ``mode``; ``target_index`` is always the
        global database index regardless of chunking.

    Example:
        >>> targets = ["AACCGCTG", "ATGCGCT", "TTATTACG"]
        >>> hits = align("ACCTG", targets, gap_open=2, ordered=True, device="cpu")
        >>> for res in hits:
        ...     print(res.score, targets[res.target_index])
        41 AACCGCTG
        31 ATGCGCT
        23 TTATTACG

    """
    matrix = _resolve_matrix(scoring_matrix)
    if not isinstance(database, BaseDatabase):
        database = Database(database, matrix.alphabet)
    aligner = Aligner(
        matrix, gap_open=gap_open, gap_extend=gap_extend, device=device
    )

    if threads < 0:
        # mirror multiprocessing.pool.ThreadPool's contract instead of
        # looping forever in the chunk planner
        raise ValueError("Number of threads must be at least 0")
    n = len(database)
    threads = min(threads, n) or 1  # no more workers than targets

    search = lambda start, end: aligner.align(  # noqa: E731
        query,
        database,
        mode=mode,
        overflow=overflow,
        algorithm=algorithm,
        start=start,
        end=end,
    )

    if threads == 1:
        # single dispatch: device-level parallelism inside the engine
        yield from search(0, n)
        return

    bounds = list(_chunk_bounds(n, threads))
    if pool is None:
        pool_cm = multiprocessing.pool.ThreadPool(min(threads, len(bounds)))
    else:
        pool_cm = contextlib.nullcontext(pool)
    with pool_cm as active:
        mapper = active.imap if ordered else active.imap_unordered
        for hits in mapper(lambda se: search(*se), bounds):
            yield from hits
