"""Search result classes: ``ScoreResult`` / ``EndResult`` / ``FullResult``.

Port of ``pyopal_tpu/results.py``.  `ScoreResult` and `EndResult` are
the C types of ``native/results.c`` (``pyopal_tpu_torch.native._results``)
and the bulk builders are its C builders, as in the reference; the
pure-Python classes and builders below are the fallback where the
extension did not build, with the same values, exception types and
messages.

Parity with the reference result objects
(upstream PyOpal ``src/pyopal/lib.pyx:783-1119``), including the
alignment op encoding (``M=0, D=1, I=2, X=3``; ``lib.pyx:97-102``), the
SAM CIGAR derivation (``lib.pyx:999-1037``), identity
(``lib.pyx:1039-1052``) and coverage with reference-gap edge trimming
(``lib.pyx:1054-1119``).

In the reference, the kernel mutates preallocated C structs through raw
pointers; here the kernels return dense score/end arrays and result
objects are constructed from them on the host.
"""

from __future__ import annotations

import operator
import struct
import sys

import numpy as np

# Alignment operations (reference constants, lib.pyx:97-102).
OP_MATCH = 0
OP_DEL = 1  # gap in the target: a query residue aligned to nothing
OP_INS = 2  # gap in the query: a target residue aligned to nothing
OP_MISMATCH = 3

#: op value -> character in the ``alignment`` string (lib.pyx:984-996)
_ALIGN_SYMBOLS = "MDIX"
#: ``op % 3`` -> character in the SAM CIGAR string (lib.pyx:999-1037)
_CIGAR_SYMBOLS = "MID"

_OP_FROM_SYMBOL = {c: i for i, c in enumerate(_ALIGN_SYMBOLS)}


def cigar_string(ops):
    """SAM CIGAR string for an op array (`None` for empty alignments).

    Folds mismatches into matches and run-length encodes, exactly as
    the reference does (``lib.pyx:1019-1036``); shared by
    `FullResult.cigar` and the columnar full-mode front-ends.
    """
    ops = np.asarray(ops, dtype=np.uint8)
    if ops.shape[0] == 0:
        return None
    folded = ops % 3
    chunks = []
    count = 0
    current = int(folded[0])
    for symbol in folded:
        if symbol == current:
            count += 1
        else:
            chunks.append(str(count))
            chunks.append(_CIGAR_SYMBOLS[current])
            current = int(symbol)
            count = 1
    chunks.append(str(count))
    chunks.append(_CIGAR_SYMBOLS[current])
    return "".join(chunks)


#: the C types' field ranges: ``Py_ssize_t`` target indices, ``long``
#: scores and ends
_SSIZE_MAX = sys.maxsize
_LONG_MAX = (1 << (8 * struct.calcsize("l") - 1)) - 1


def _parse_args(names, args, kwargs):
    """Arguments given by position or name, refused with the messages
    of CPython's ``PyArg_ParseTupleAndKeywords`` for a format of
    required objects only, the C types' parser."""
    given = len(args) + len(kwargs)
    if given > len(names):
        kind = "" if args else "keyword "
        raise TypeError(
            f"function takes at most {len(names)} {kind}arguments "
            f"({given} given)"
        )
    values = list(args)
    for pos, name in enumerate(names[len(args):], len(args) + 1):
        if name not in kwargs:
            raise TypeError(
                f"function missing required argument '{name}' (pos {pos})"
            )
        values.append(kwargs[name])
    return values


def _check_range(fields):
    """``OverflowError`` like the C conversions where a ``(value, limit,
    C type)`` field does not fit; the C code converts every field before
    it checks, so the last field out of range names the type."""
    for value, limit, ctype in reversed(fields):
        if not -limit - 1 <= value <= limit:
            raise OverflowError(f"Python int too large to convert to C {ctype}")


def _score_fields(target_index, score):
    """``ScoreResult_init`` of ``native/results.c``: ``__index__``
    semantics, a ``Py_ssize_t`` index and a ``long`` score."""
    target_index = operator.index(target_index)
    score = operator.index(score)
    _check_range([(target_index, _SSIZE_MAX, "ssize_t"),
                  (score, _LONG_MAX, "long")])
    return target_index, score


class ScoreResult:
    """Per-target hit carrying the alignment score (``score`` mode)."""

    __slots__ = ("_target_index", "_score")

    def __init__(self, *args, **kwargs):
        self._target_index, self._score = _score_fields(
            *_parse_args(("target_index", "score"), args, kwargs)
        )

    def __repr__(self):
        ty = type(self).__name__
        return f"{ty}({self.target_index}, score={self.score!r})"

    def __reduce__(self):
        return type(self), (self.target_index, self.score)

    def __eq__(self, other):
        if not isinstance(other, _PyScoreResult):
            return NotImplemented
        return self.__reduce__()[1] == other.__reduce__()[1]

    def __hash__(self):
        return hash(self.__reduce__()[1])

    @property
    def target_index(self):
        """`int`: Position of the target in the searched database."""
        return self._target_index

    @property
    def score(self):
        """`int`: Alignment score under the search parameters."""
        return self._score


class EndResult(ScoreResult):
    """Hit carrying score plus end coordinates (``end`` mode)."""

    __slots__ = ("_query_end", "_target_end")

    def __init__(self, *args, **kwargs):
        ti, sc, qe, te = _parse_args(
            ("target_index", "score", "query_end", "target_end"), args, kwargs
        )
        self._target_index, self._score = _score_fields(ti, sc)
        # int(x) semantics, like the C type's PyNumber_Long
        qe, te = int(qe), int(te)
        _check_range([(qe, _LONG_MAX, "long"), (te, _LONG_MAX, "long")])
        self._query_end, self._target_end = qe, te

    def __repr__(self):
        ty = type(self).__name__
        return (
            f"{ty}({self.target_index}, "
            f"score={self.score!r}, "
            f"query_end={self.query_end!r}, "
            f"target_end={self.target_end!r})"
        )

    def __reduce__(self):
        return type(self), (
            self.target_index,
            self.score,
            self.query_end,
            self.target_end,
        )

    @property
    def query_end(self):
        """`int`: Query coordinate of the last aligned pair.

        For an *empty* alignment — a local (``sw``) search in which no
        cell ever scores above zero — there is no end cell and the
        coordinate is the sentinel ``-1`` (the same convention as the
        dense arrays returned by `Aligner.align_arrays`; reference
        analog: ``opalInitSearchResult`` leaves end locations at ``-1``,
        upstream PyOpal ``src/pyopal/opal.pxd:36-38``).
        """
        return self._query_end

    @property
    def target_end(self):
        """`int`: Target coordinate of the last aligned pair.

        ``-1`` for empty alignments; see `query_end`.
        """
        return self._target_end


#: the pure-Python classes, kept under these names where the C types
#: take the public ones
_PyScoreResult, _PyEndResult = ScoreResult, EndResult


def _py_build_score_results(start, scores):
    """Bulk-construct Python `ScoreResult` objects (bypasses ``__init__``)."""
    new = _PyScoreResult.__new__
    out = []
    append = out.append
    for i, v in enumerate(scores.tolist()):
        r = new(_PyScoreResult)
        r._target_index = start + i
        r._score = v
        append(r)
    return out


def _py_build_end_results(start, scores, q_ends, t_ends):
    """Bulk-construct Python `EndResult` objects (bypasses ``__init__``)."""
    new = _PyEndResult.__new__
    out = []
    append = out.append
    for i, (v, qe, te) in enumerate(
        zip(scores.tolist(), q_ends.tolist(), t_ends.tolist())
    ):
        r = new(_PyEndResult)
        r._target_index = start + i
        r._score = v
        r._query_end = qe
        r._target_end = te
        append(r)
    return out


build_score_results = _py_build_score_results
build_end_results = _py_build_end_results

# Native (C extension) result types and bulk builders: identical
# semantics, ~20x faster bulk construction (the per-search cost of
# wrapping 10k+ hits would otherwise rival the kernel time).
try:
    from .native import _results as _native_results
except ImportError:  # pragma: no cover - the extension did not build
    _native_results = None

if _native_results is not None:
    ScoreResult = _native_results.ScoreResult
    EndResult = _native_results.EndResult

    def build_score_results(start, scores):  # noqa: F811
        """Bulk-construct `ScoreResult` objects in C."""
        return _native_results.build_score_results(
            int(start), np.ascontiguousarray(scores, dtype=np.int32)
        )

    def build_end_results(start, scores, q_ends, t_ends):  # noqa: F811
        """Bulk-construct `EndResult` objects in C."""
        return _native_results.build_end_results(
            int(start),
            np.ascontiguousarray(scores, dtype=np.int32),
            np.ascontiguousarray(q_ends, dtype=np.int32),
            np.ascontiguousarray(t_ends, dtype=np.int32),
        )


class FullResult(EndResult):
    """Hit carrying the complete alignment (``full`` mode)."""

    __slots__ = (
        "_query_start",
        "_target_start",
        "_query_length",
        "_target_length",
        "_ops",
    )

    def __init__(
        self,
        target_index,
        score,
        query_end,
        target_end,
        query_start,
        target_start,
        query_length,
        target_length,
        alignment,
    ):
        if alignment is None:
            raise TypeError("alignment cannot be None")
        super().__init__(target_index, score, query_end, target_end)
        self._query_start = int(query_start)
        self._target_start = int(target_start)
        self._query_length = int(query_length)
        self._target_length = int(target_length)
        if isinstance(alignment, str):
            self._ops = np.array(
                [_OP_FROM_SYMBOL[c] for c in alignment], dtype=np.uint8
            )
        else:
            self._ops = np.asarray(alignment, dtype=np.uint8)
        self._ops.setflags(write=False)

    def __repr__(self):
        ty = type(self).__name__
        return (
            f"{ty}({self.target_index}, "
            f"score={self.score!r}, "
            f"query_end={self.query_end!r}, "
            f"target_end={self.target_end!r}, "
            f"query_start={self.query_start!r}, "
            f"target_start={self.target_start!r}, "
            f"query_length={self.query_length!r}, "
            f"target_length={self.target_length!r}, "
            f"alignment={self.alignment!r})"
        )

    def __reduce__(self):
        return (
            type(self),
            (
                self.target_index,
                self.score,
                self.query_end,
                self.target_end,
                self.query_start,
                self.target_start,
                self.query_length,
                self.target_length,
                self.alignment,
            ),
        )

    @property
    def query_start(self):
        """`int`: Query coordinate of the first aligned pair."""
        assert self._query_start >= 0
        return self._query_start

    @property
    def target_start(self):
        """`int`: Target coordinate of the first aligned pair."""
        assert self._target_start >= 0
        return self._target_start

    @property
    def query_length(self):
        """`int`: Full (unaligned) query length."""
        assert self._query_length >= 0
        return self._query_length

    @property
    def target_length(self):
        """`int`: Full (unaligned) target length."""
        assert self._target_length >= 0
        return self._target_length

    @property
    def alignment(self):
        """`str`: A string of ``M``/``D``/``I``/``X`` alignment operations."""
        return "".join(_ALIGN_SYMBOLS[op] for op in self._ops)

    def cigar(self):
        """Render the alignment as a SAM-style CIGAR string.

        Returns:
            `str`: A CIGAR string in SAM format describing the alignment.

        Example:
            >>> aligner = Aligner(device="cpu")
            >>> db = Database(["AACCGCTG"])
            >>> hit = aligner.align("ACCTCG", db, mode="full", algorithm="nw")[0]
            >>> hit.cigar()
            '1D5M1D1M'

        """
        return cigar_string(self._ops)

    def identity(self):
        """Fraction of aligned columns that are exact matches.

        Returns:
            `float`: The identity of the alignment as a fraction
            (between *0* and *1*).

        """
        matches = int((self._ops == OP_MATCH).sum())
        mismatches = int((self._ops == OP_MISMATCH).sum())
        if matches + mismatches == 0:
            # gap-only alignment: nan, silently, like the reference's C
            # float division (lib.pyx:1039-1052) — not a RuntimeWarning
            return float("nan")
        return float(np.float32(matches) / np.float32(matches + mismatches))

    def coverage(self, reference="query"):
        """Fraction of a sequence spanned by the alignment.

        Arguments:
            reference (`str`): The reference sequence to take to compute
                the coverage: either ``query`` or ``target``.

        Returns:
            `float`: The coverage of the alignment against the
            reference, as a fraction (between *0* and *1*).

        Example:
            >>> aligner = Aligner(device="cpu")
            >>> db = Database(["AACCGCTG"])
            >>> hit = aligner.align("ACCTCG", db, mode="full", algorithm="nw")[0]
            >>> hit.coverage("query")
            1.0
            >>> hit.coverage("target")
            0.875

        """
        if reference == "query":
            reflength = self._query_length
            length = self.query_end + 1 - self._query_start
            operation = OP_DEL
        elif reference == "target":
            reflength = self._target_length
            length = self.target_end + 1 - self._target_start
            operation = OP_INS
        else:
            raise ValueError(f"Invalid coverage reference: {reference!r}")

        # trim alignment sides if they correspond to a gap in the
        # reference (lib.pyx:1105-1114)
        for op in self._ops:
            if op == operation:
                length -= 1
            else:
                break
        for op in self._ops[::-1]:
            if op == operation:
                length -= 1
            else:
                break

        if length < 0:
            return 0.0
        return float(np.float32(length) / np.float32(reflength))
