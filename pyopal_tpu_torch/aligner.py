"""The `Aligner`: validated search entry point.

Port of ``pyopal_tpu/aligner.py``: the same parameter validation,
`align`, `align_top_k`, `align_batch`, `align_arrays`, `align_many` and
`align_async` in ``score``, ``end`` and ``full`` modes, plus a ``device``
argument.  The device defaults to ``"cuda"``; without a CUDA device the
constructor raises unless the caller asks for ``device="cpu"``, where the
same dispatch runs the kernels' plain PyTorch versions.  Full mode runs
the score+ends pass, then the traceback of `ops.traceback` (T1, T2).  The
``overflow`` strategies are validated for API parity and are no-ops:
every score is computed exactly in int32.
"""

from __future__ import annotations

import itertools
import threading

import numpy as np
import torch

from .alphabet import Alphabet
from .database import BaseDatabase
from .matrices import ScoringMatrix
from .ops import engine
from .results import build_end_results, build_score_results
from .utils.profiling import span, spanned

UINT32_MAX = 0xFFFFFFFF

_SEARCH_MODES = ("score", "end", "full")
_OVERFLOW_MODES = ("simple", "buckets")
_ALGORITHMS = ("nw", "hw", "ov", "sw")

def resolve_device(device) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device must be available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the "
            "kernels' plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {dev}")
    return dev


def _clamp_slice(size: int, start: int, end: int):
    """Validate and clamp a database slice, shared by every search
    entry point (reference contract: ``lib.pyx:1365-1370`` — negative
    offsets are rejected rather than wrapping Python-style, which
    would silently duplicate targets)."""
    if start < 0:
        raise IndexError("database slice start cannot be negative")
    if end < start:
        raise IndexError("database slice end is lower than start")
    return start, min(end, size)


class Aligner:
    """A GPU database-search aligner.

    One `Aligner` holds a scoring matrix, affine-gap parameters and a
    device, and scores queries against every target of a database in
    one kernel launch per query tier (a query beyond 4096 residues: one
    launch at its own tier, or one per 2048-row segment), one database
    sequence per GPU thread.  Instances are stateless between calls and safe to share
    across threads; searches take the database's read lock for their
    duration.

    Attributes:
        scoring_matrix (`~pyopal_tpu_torch.ScoringMatrix`): The substitution
            matrix scores are drawn from.
        alphabet (`~pyopal_tpu_torch.Alphabet`): Encoding alphabet, derived
            from the matrix's column letters.
        gap_open (`int`): Penalty :math:`G` charged when a gap opens.
        gap_extend (`int`): Penalty :math:`E` for each extra gap
            column, so a length-:math:`N` gap costs
            :math:`G + (N - 1)E`.
        device (`torch.device`): Where the searches run.

    """

    _DEFAULT_SCORING_MATRIX = ScoringMatrix.from_name("BLOSUM50")
    _DEFAULT_GAP_OPEN = 3
    _DEFAULT_GAP_EXTEND = 1

    def __init__(
        self,
        scoring_matrix=None,
        gap_open: int = _DEFAULT_GAP_OPEN,
        gap_extend: int = _DEFAULT_GAP_EXTEND,
        *,
        device=None,
    ):
        """Create a new aligner with the given parameters.

        Arguments:
            scoring_matrix (`~pyopal_tpu_torch.ScoringMatrix` or `str`): The
                scoring matrix, either as a `ScoringMatrix` object or
                as the name of a bundled matrix to load with
                `ScoringMatrix.from_name`.
            gap_open (`int`): The gap opening penalty.
            gap_extend (`int`): The gap extension penalty.
            device (`str` or `torch.device`): ``"cuda"`` (the default)
                or ``"cpu"``.

        Raises:
            `ValueError`: When the given scoring matrix is not an
                integer matrix.
            `TypeError`: When ``scoring_matrix`` is neither a name nor
                a `ScoringMatrix`.
            `RuntimeError`: When CUDA is requested (or defaulted to)
                but not available.

        """
        self.device = resolve_device(device)
        if scoring_matrix is None:
            self.scoring_matrix = self._DEFAULT_SCORING_MATRIX
        elif isinstance(scoring_matrix, str):
            self.scoring_matrix = ScoringMatrix.from_name(scoring_matrix)
        elif isinstance(scoring_matrix, ScoringMatrix):
            self.scoring_matrix = scoring_matrix
        else:
            ty = type(scoring_matrix).__name__
            raise TypeError(f"expected str or ScoringMatrix, found {ty}")

        self.alphabet = Alphabet(self.scoring_matrix.alphabet)
        self.gap_open = int(gap_open)
        self.gap_extend = int(gap_extend)

        if not self.scoring_matrix.is_integer():
            raise ValueError("Integer scoring matrix is expected")
        self._int_matrix = self.scoring_matrix.int_data()

    def __repr__(self):
        args = []
        if self.scoring_matrix != self._DEFAULT_SCORING_MATRIX:
            args.append(f"{self.scoring_matrix!r}")
        if self.gap_open != self._DEFAULT_GAP_OPEN:
            args.append(f"gap_open={self.gap_open!r}")
        if self.gap_extend != self._DEFAULT_GAP_EXTEND:
            args.append(f"gap_extend={self.gap_extend!r}")
        if self.device.type != "cuda":
            args.append(f"device={str(self.device)!r}")
        return f"{type(self).__name__}({', '.join(args)})"

    def __reduce__(self):
        return (
            _make_aligner,
            (
                self.scoring_matrix,
                self.gap_open,
                self.gap_extend,
                str(self.device),
            ),
        )

    def __eq__(self, other):
        if not isinstance(other, Aligner):
            return NotImplemented
        return self.__reduce__()[1] == other.__reduce__()[1]

    def __hash__(self):
        return hash(
            (Aligner, self.scoring_matrix, self.gap_open, self.gap_extend)
        )

    @spanned("pyopal.align")
    def align(
        self,
        query,
        database,
        *,
        mode: str = "score",
        overflow: str = "buckets",
        algorithm: str = "sw",
        start: int = 0,
        end: int = UINT32_MAX,
    ):
        """Align the query sequence to all targets of the database.

        Arguments:
            query (`str` or byte-like object): The sequence to query
                the database with.
            database (`~pyopal_tpu_torch.BaseDatabase`): The database
                sequences to align the query to.

        Keyword Arguments:
            mode (`str`): ``score`` to only report scores (default),
                ``end`` to also report end coordinates, ``full`` to
                report full alignments.
            overflow (`str`): ``simple`` or ``buckets``; accepted for
                API parity with the reference precision-escalation
                pipeline — every score is computed exactly in int32,
                so neither strategy can overflow.
            algorithm (`str`): ``nw`` (global), ``hw`` (semi-global,
                free gaps on query edges), ``ov`` (overlap), or ``sw``
                (local, default).
            start (`int`): Start offset in the database.
            end (`int`): End offset in the database.

        Returns:
            `list` of `~pyopal_tpu_torch.ScoreResult`: One result per target
            in ``database[start:end]``; the actual type depends on
            ``mode`` (`ScoreResult` / `EndResult` / `FullResult`), and
            ``target_index`` is always the global database index.

        Raises:
            `ValueError`: When any parameter is invalid or the database
                alphabet differs from the aligner's.
            `IndexError`: When ``end`` is lower than ``start``.

        """
        if query is None:
            raise TypeError("query cannot be None")
        if database is None:
            raise TypeError("database cannot be None")
        if not isinstance(database, BaseDatabase):
            ty = type(database).__name__
            raise TypeError(f"expected BaseDatabase, found {ty}")

        if mode not in _SEARCH_MODES:
            raise ValueError(f"invalid search mode: {mode!r}")
        if overflow not in _OVERFLOW_MODES:
            raise ValueError(f"invalid overflow mode: {overflow!r}")
        if algorithm not in _ALGORITHMS:
            raise ValueError(f"invalid algorithm: {algorithm!r}")

        if database.alphabet != self.alphabet:
            raise ValueError(
                "database and score matrix have different alphabets"
            )

        with span("pyopal.encode"):
            encoded = np.frombuffer(
                database.alphabet.encode(query), dtype=np.uint8
            )

        with database.lock.read:
            start, end = _clamp_slice(database.get_size(), start, end)
            if start > end:
                return []
            return engine.search(
                database,
                encoded,
                self._int_matrix,
                self.gap_open,
                self.gap_extend,
                mode,
                algorithm,
                start,
                end,
                device=self.device,
            )

    def align_top_k(
        self,
        query,
        database,
        *,
        k: int = 100,
        overflow: str = "buckets",
        algorithm: str = "sw",
        start: int = 0,
        end: int = UINT32_MAX,
    ):
        """Full alignments for the ``k`` best-scoring targets.

        The reference's documented search workflow (score pass -> top
        hits -> full-mode realign) as one call: one score+ends pass over
        ``database[start:end)``, top-k selection on the host (ties broken
        by database order), and batched traceback of only the selected
        targets.

        Returns:
            `list` of `~pyopal_tpu_torch.FullResult`: At most ``k``
            results sorted by descending score, with global
            ``target_index``.
        """
        if query is None:
            raise TypeError("query cannot be None")
        if not isinstance(database, BaseDatabase):
            ty = type(database).__name__
            raise TypeError(f"expected BaseDatabase, found {ty}")
        if overflow not in _OVERFLOW_MODES:
            raise ValueError(f"invalid overflow mode: {overflow!r}")
        if algorithm not in _ALGORITHMS:
            raise ValueError(f"invalid algorithm: {algorithm!r}")
        if k < 0:
            raise ValueError(f"invalid k: {k!r}")
        if database.alphabet != self.alphabet:
            raise ValueError(
                "database and score matrix have different alphabets"
            )
        encoded = np.frombuffer(
            database.alphabet.encode(query), dtype=np.uint8
        )
        with database.lock.read:
            start, end = _clamp_slice(database.get_size(), start, end)
            if start > end:
                return []
            return engine.search_top_k(
                database,
                encoded,
                self._int_matrix,
                self.gap_open,
                self.gap_extend,
                algorithm,
                k,
                start,
                end,
                device=self.device,
            )

    @spanned("pyopal.align_batch")
    def align_batch(
        self,
        queries,
        database,
        *,
        mode: str = "score",
        overflow: str = "buckets",
        algorithm: str = "sw",
        start: int = 0,
        end: int = UINT32_MAX,
    ):
        """Align several query sequences against the database, pipelined.

        Extension over the reference API: all queries' kernel launches
        are issued before the results are copied back, one copy per
        launch.  Semantically
        equivalent to ``[self.align(q, database, ...) for q in
        queries]``.

        Arguments and result types match `align`; returns a list with
        one result list per query (``ScoreResult`` / ``EndResult`` /
        ``FullResult`` by ``mode``).  ``mode="full"`` reconstructs every
        target's alignment; for top-hit workflows prefer `align_top_k`,
        which traces back only the winners.
        """
        if mode not in _SEARCH_MODES:
            raise ValueError(f"invalid batch search mode: {mode!r}")
        if overflow not in _OVERFLOW_MODES:
            raise ValueError(f"invalid overflow mode: {overflow!r}")
        if algorithm not in _ALGORITHMS:
            raise ValueError(f"invalid algorithm: {algorithm!r}")
        if database.alphabet != self.alphabet:
            raise ValueError(
                "database and score matrix have different alphabets"
            )
        with span("pyopal.encode"):
            encoded = [
                np.frombuffer(database.alphabet.encode(q), dtype=np.uint8)
                for q in queries
            ]
        with database.lock.read:
            start, end = _clamp_slice(database.get_size(), start, end)
            if start > end:
                return [[] for _ in encoded]
            if mode == "full":
                return engine.search_full_batch(
                    database,
                    start,
                    end,
                    encoded,
                    self._int_matrix,
                    self.gap_open,
                    self.gap_extend,
                    algorithm,
                    device=self.device,
                )
            scores, q_ends, t_ends = engine.search_scores_batch(
                database,
                start,
                end,
                encoded,
                self._int_matrix,
                self.gap_open,
                self.gap_extend,
                algorithm,
                with_ends=(mode == "end"),
                device=self.device,
            )

        out = []
        with span("pyopal.results"):
            for qi in range(len(encoded)):
                if mode == "score":
                    out.append(build_score_results(start, scores[qi]))
                else:
                    out.append(
                        build_end_results(
                            start, scores[qi], q_ends[qi], t_ends[qi]
                        )
                    )
        return out

    @spanned("pyopal.align_arrays")
    def align_arrays(
        self,
        queries,
        database,
        *,
        mode: str = "score",
        overflow: str = "buckets",
        algorithm: str = "sw",
        start: int = 0,
        end: int = UINT32_MAX,
    ):
        """Columnar batch search: raw numpy arrays instead of objects.

        Extension for high-throughput serving: identical
        semantics to `align_batch`, but results come back as dense
        arrays (no per-hit Python objects).

        Returns:
            `dict`: ``{"scores": (n_queries, n_targets) int32}`` plus,
            for ``mode="end"``, ``"query_ends"`` and ``"target_ends"``
            arrays of the same shape (0-based coordinates, ``-1`` for
            empty alignments).  ``mode="full"`` adds ``"query_starts"``
            / ``"target_starts"`` (``0`` for empty alignments) and
            ``"cigars"``, an object array of SAM CIGAR strings
            (`None` for empty alignments, like `FullResult.cigar`).
        """
        if mode not in _SEARCH_MODES:
            raise ValueError(f"invalid batch search mode: {mode!r}")
        if overflow not in _OVERFLOW_MODES:
            raise ValueError(f"invalid overflow mode: {overflow!r}")
        if algorithm not in _ALGORITHMS:
            raise ValueError(f"invalid algorithm: {algorithm!r}")
        if database.alphabet != self.alphabet:
            raise ValueError(
                "database and score matrix have different alphabets"
            )
        with span("pyopal.encode"):
            encoded = [
                np.frombuffer(database.alphabet.encode(q), dtype=np.uint8)
                for q in queries
            ]
        with database.lock.read:
            start, end = _clamp_slice(database.get_size(), start, end)
            if start > end:
                empty = np.zeros((len(encoded), 0), dtype=np.int32)
                out = {"scores": empty}
                if mode != "score":
                    out["query_ends"] = empty.copy()
                    out["target_ends"] = empty.copy()
                if mode == "full":
                    out["query_starts"] = empty.copy()
                    out["target_starts"] = empty.copy()
                    out["cigars"] = np.empty(empty.shape, dtype=object)
                return out
            scores, q_ends, t_ends = engine.search_scores_batch(
                database,
                start,
                end,
                encoded,
                self._int_matrix,
                self.gap_open,
                self.gap_extend,
                algorithm,
                with_ends=(mode != "score"),
                device=self.device,
            )
            if mode == "full":
                q_starts, t_starts, cigars = engine.full_arrays_from_ends(
                    database,
                    start,
                    end,
                    encoded,
                    self._int_matrix,
                    self.gap_open,
                    self.gap_extend,
                    algorithm,
                    (scores, q_ends, t_ends),
                    device=self.device,
                )
        if mode == "score":
            return {"scores": scores}
        out = {
            "scores": scores,
            "query_ends": q_ends,
            "target_ends": t_ends,
        }
        if mode == "full":
            out["query_starts"] = q_starts
            out["target_starts"] = t_starts
            out["cigars"] = cigars
        return out

    def align_many(
        self,
        queries,
        database,
        *,
        mode: str = "score",
        overflow: str = "buckets",
        algorithm: str = "sw",
        start: int = 0,
        end: int = UINT32_MAX,
        batch_size: int = 32,
    ):
        """Stream result lists for a sequence of queries, pipelined.

        A lazy generator over ``queries``: queries are pulled and
        dispatched in micro-batches of ``batch_size`` (each batch is
        one `align_batch` call), and per-query result lists are
        yielded in order.

        Semantically equivalent to ``(self.align(q, database, ...)
        for q in queries)`` except that each batch reflects the
        database state when its first result is pulled.
        """
        if batch_size < 1:
            raise ValueError(f"invalid batch_size: {batch_size!r}")
        it = iter(queries)
        while True:
            chunk = list(itertools.islice(it, batch_size))
            if not chunk:
                return
            yield from self.align_batch(
                chunk,
                database,
                mode=mode,
                overflow=overflow,
                algorithm=algorithm,
                start=start,
                end=end,
            )

    def align_async(
        self,
        query,
        database,
        *,
        mode: str = "score",
        overflow: str = "buckets",
        algorithm: str = "sw",
        start: int = 0,
        end: int = UINT32_MAX,
    ) -> "AlignFuture":
        """Enqueue a query; resolve later, batched with its neighbors.

        Returns an `AlignFuture` whose ``result()`` yields the same
        list `align` returns.  All futures created with identical
        parameters against the same database form one pending stream
        on this aligner: the first ``result()`` call flushes every
        pending query of that stream as one `align_batch` call, so N
        submitted queries share one set of kernel launches.

        Validation happens at submit time; the search itself runs at
        flush time, under the database read lock, reflecting the
        database state then (standard future semantics).
        """
        if mode not in _SEARCH_MODES:
            raise ValueError(f"invalid batch search mode: {mode!r}")
        if overflow not in _OVERFLOW_MODES:
            raise ValueError(f"invalid overflow mode: {overflow!r}")
        if algorithm not in _ALGORITHMS:
            raise ValueError(f"invalid algorithm: {algorithm!r}")
        if database.alphabet != self.alphabet:
            raise ValueError(
                "database and score matrix have different alphabets"
            )
        # validate eagerly: bad symbols and malformed slices raise
        # here, not at flush (the size-dependent clamp still happens
        # at flush, against the database state then)
        database.alphabet.encode(query)
        if start < 0:
            raise IndexError("database slice start cannot be negative")
        if end < start:
            raise IndexError("database slice end is lower than start")
        key = (id(database), mode, overflow, algorithm, start, end)
        with self.__dict__.setdefault(
            "_async_dict_lock", threading.Lock()
        ):
            streams = self.__dict__.setdefault("_async_streams", {})
            stream = streams.get(key)
            if stream is None:
                stream = _AsyncStream(
                    self, key, database, mode, overflow, algorithm,
                    start, end,
                )
                streams[key] = stream
            return stream.submit(query)


def _make_aligner(scoring_matrix, gap_open, gap_extend, device):
    """Unpickling helper: rebuild an `Aligner` with its device."""
    return Aligner(scoring_matrix, gap_open, gap_extend, device=device)


class _AsyncStream:
    """Pending queries sharing one (database, params) stream.

    Thread contract: ``submit``/``flush`` are safe from any thread.
    The batch search runs *outside* the stream lock, so concurrent
    ``submit`` calls land in the next batch without blocking behind an
    in-flight flush; a ``result()`` on a future popped by another
    thread's in-flight flush waits on the stream condition until that
    flush resolves (or fails) it.  If the batch search raises, the
    exception is recorded on every popped future (re-raised from their
    ``result()``) and propagated to the flushing caller.  A fully
    drained stream removes itself from the aligner's registry so
    neither the stream nor its database reference outlives the work.
    """

    def __init__(
        self, aligner, key, database, mode, overflow, algorithm, start, end
    ):
        self.aligner = aligner
        self.key = key
        self.database = database
        self.mode = mode
        self.overflow = overflow
        self.algorithm = algorithm
        self.start = start
        self.end = end
        self.pending: list = []
        self._cond = threading.Condition()

    def submit(self, query) -> "AlignFuture":
        fut = AlignFuture(self)
        with self._cond:
            self.pending.append((fut, query))
        return fut

    def flush(self) -> None:
        batch: list = []
        try:
            with self._cond:
                batch, self.pending = self.pending, []
            if batch:
                results = self.aligner.align_batch(
                    [q for _, q in batch],
                    self.database,
                    mode=self.mode,
                    overflow=self.overflow,
                    algorithm=self.algorithm,
                    start=self.start,
                    end=self.end,
                )
                with self._cond:
                    for (fut, _), res in zip(batch, results):
                        fut._result = res
                        fut._done = True
                    self._cond.notify_all()
        finally:
            # any popped future still unresolved here was orphaned by
            # an exception (or an async interrupt landing between the
            # pop and resolution): record the failure so waiters never
            # hang, then propagate
            undone = [fut for fut, _ in batch if not fut._done]
            if undone:
                import sys

                exc = sys.exc_info()[1] or RuntimeError(
                    "flush aborted before resolving futures"
                )
                with self._cond:
                    for fut in undone:
                        fut._exception = exc
                        fut._done = True
                    self._cond.notify_all()
            # drop the drained stream from the registry (under the
            # dict lock; a submit racing this creates a fresh stream)
            dict_lock = self.aligner.__dict__.get("_async_dict_lock")
            if dict_lock is not None:
                with dict_lock, self._cond:
                    streams = self.aligner.__dict__.get(
                        "_async_streams", {}
                    )
                    if streams.get(self.key) is self and not self.pending:
                        del streams[self.key]

    def _wait(self, fut: "AlignFuture") -> None:
        """Block until ``fut`` (popped by an in-flight flush) resolves."""
        with self._cond:
            while not fut._done:
                self._cond.wait()


class AlignFuture:
    """Deferred result of `Aligner.align_async`."""

    __slots__ = ("_stream", "_result", "_exception", "_done")

    def __init__(self, stream):
        self._stream = stream
        self._result = None
        self._exception = None
        self._done = False

    def done(self) -> bool:
        """Whether the result is already materialized."""
        return self._done

    def result(self):
        """The result list, flushing the pending stream if needed."""
        if not self._done:
            self._stream.flush()
        if not self._done:
            # popped by another thread's in-flight flush: wait for it
            self._stream._wait(self)
        if self._exception is not None:
            raise self._exception
        return self._result
