"""Search result classes: ``ScoreResult`` / ``EndResult`` / ``FullResult``.

Port of ``pyopal_tpu/results.py``: the pure-Python classes and bulk
builders (the C extension's types of ``pyopal_tpu/native/`` are not
carried over).

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


class ScoreResult:
    """Per-target hit carrying the alignment score (``score`` mode)."""

    __slots__ = ("_target_index", "_score")

    def __init__(self, target_index, score):
        self._target_index = target_index.__index__()
        self._score = score.__index__()

    def __repr__(self):
        ty = type(self).__name__
        return f"{ty}({self.target_index}, score={self.score!r})"

    def __reduce__(self):
        return type(self), (self.target_index, self.score)

    def __eq__(self, other):
        if not isinstance(other, ScoreResult):
            return NotImplemented
        return self.__reduce__()[1] == other.__reduce__()[1]

    def __hash__(self):
        return hash(self.__reduce__()[1])

    @property
    def target_index(self):
        """`int`: Position of the target in the searched database."""
        assert self._target_index >= 0
        return self._target_index

    @property
    def score(self):
        """`int`: Alignment score under the search parameters."""
        return self._score


def build_score_results(start, scores):
    """Bulk-construct `ScoreResult` objects (bypasses ``__init__``)."""
    new = ScoreResult.__new__
    out = []
    append = out.append
    for i, v in enumerate(scores.tolist()):
        r = new(ScoreResult)
        r._target_index = start + i
        r._score = v
        append(r)
    return out


def build_end_results(start, scores, q_ends, t_ends):
    """Bulk-construct `EndResult` objects (bypasses ``__init__``)."""
    new = EndResult.__new__
    out = []
    append = out.append
    for i, (v, qe, te) in enumerate(
        zip(scores.tolist(), q_ends.tolist(), t_ends.tolist())
    ):
        r = new(EndResult)
        r._target_index = start + i
        r._score = v
        r._query_end = qe
        r._target_end = te
        append(r)
    return out


class EndResult(ScoreResult):
    """Hit carrying score plus end coordinates (``end`` mode)."""

    __slots__ = ("_query_end", "_target_end")

    def __init__(self, target_index, score, query_end, target_end):
        super().__init__(target_index, score)
        self._query_end = int(query_end)
        self._target_end = int(target_end)

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
            >>> aligner = Aligner()
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
            >>> aligner = Aligner()
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
