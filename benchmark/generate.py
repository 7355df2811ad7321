"""Databases and queries made from the seed.

A configuration fixes its database's length multiset and its letters
(``scoring.letters``, the rows of its table): the same for every seed.
The seed picks only the residues (uniform over the letters, drawn on
the device in one call) and, for queries, where in the database each
query's homologous window starts and which of its residues are
substituted.  Every call of a run gets queries of its own:
calls are numbered, and each number has its own generator.

The log-normal draw is a frozen copy of ``bench.py``'s ``build_database``
lengths (``np.clip(rng.lognormal(log(350), 0.45, n).astype(int), 30,
4000)`` with ``default_rng(12071)``: 12,071 sequences, 4,683,440
residues).
"""

from __future__ import annotations

import numpy as np
import torch

#: the 20 amino acids, in the order of the protein configurations'
#: matrix rows: the letters where a caller names none
LETTERS = b"ARNDCQEGHILKMFPSTWYV"

#: generator streams of one run: warm-up calls, timed calls, the check's
#: sample of targets and calls
STREAM_WARMUP = 1
STREAM_WINDOW = 0
STREAM_CHECK = 2


def seed_key(seed: int) -> int:
    """A run's seed as a non-negative integer for `numpy` and `torch`."""
    return int(seed) % (1 << 63)


def database_lengths(db: dict) -> np.ndarray:
    """The configuration's fixed multiset of target lengths, in database
    order; checked against its stated count and residues."""
    n = int(db["count"])
    spec = db["lengths"]
    lo, hi = spec["clip"]
    if spec["kind"] == "lognormal_draw":
        rng = np.random.default_rng(spec["seed"])
        lengths = np.clip(
            rng.lognormal(np.log(spec["median"]), spec["sigma"], n).astype(int),
            lo, hi,
        ).astype(np.int64)
    elif spec["kind"] == "lognormal_fit":
        lengths = _lognormal_fit(
            n, int(db["residues"]), spec["sigma"], lo, hi, spec["seed"]
        )
    else:
        raise ValueError(f"unknown length kind: {spec['kind']!r}")
    if lengths.shape[0] != n or int(lengths.sum()) != int(db["residues"]):
        raise ValueError(
            f"length multiset gives {lengths.shape[0]} sequences and "
            f"{int(lengths.sum())} residues, the configuration states "
            f"{n} and {db['residues']}"
        )
    return lengths


def _lognormal_fit(n, residues, sigma, lo, hi, seed):
    """Log-normal lengths, clipped, whose sum is exactly ``residues``:
    the location is found by bisection, and the few residues left over
    go one each to the first sequences below the upper clip."""
    z = np.random.default_rng(seed).standard_normal(n)

    def draw(mu):
        return np.clip(np.floor(np.exp(mu + sigma * z)), lo, hi).astype(np.int64)

    a, b = 0.0, float(np.log(hi)) + 1.0
    for _ in range(64):
        mid = (a + b) / 2
        if draw(mid).sum() <= residues:
            a = mid
        else:
            b = mid
    lengths = draw(a)
    short = np.nonzero(lengths < hi)[0][: residues - int(lengths.sum())]
    lengths[short] += 1
    return lengths


def ascii_letters(letters=LETTERS) -> np.ndarray:
    """The letters (`str` or `bytes`) as a uint8 array: code -> ASCII."""
    if isinstance(letters, str):
        letters = letters.encode("ascii")
    return np.frombuffer(letters, dtype=np.uint8)


def database_codes(total: int, seed: int, device, letters=LETTERS) -> np.ndarray:
    """``total`` residue codes (0 to ``len(letters) - 1``) as one host
    array, drawn on ``device`` by one generator call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_key(seed))
    codes = torch.randint(
        0, len(letters), (int(total),), generator=gen, device=device,
        dtype=torch.uint8,
    )
    return codes.cpu().numpy()


def offsets_of(lengths: np.ndarray) -> np.ndarray:
    """Start of each target in the concatenated residues."""
    return np.concatenate(([0], np.cumsum(lengths)[:-1])).astype(np.int64)


def ascii_sequences(codes: np.ndarray, lengths: np.ndarray,
                    letters=LETTERS) -> list:
    """The database as letters: one read-only view per target."""
    text = ascii_letters(letters)[codes]
    return np.split(text, np.cumsum(lengths)[:-1])


def query_lengths(traffic: dict, db_lengths: np.ndarray) -> list:
    """The cycle of query lengths the traffic walks through in order."""
    spec = traffic["lengths"]
    if "values" in spec:
        return [int(x) for x in spec["values"]]
    if "database_quantiles" in spec:
        k = int(spec["database_quantiles"])
        ordered = np.sort(db_lengths)
        at = ((np.arange(k) + 0.5) / k * ordered.shape[0]).astype(np.int64)
        return [int(x) for x in ordered[at]]
    raise ValueError(f"unknown query lengths: {spec!r}")


class Call:
    """The queries of one call: codes, letters, and where each query's
    homologous window starts in the concatenated database."""

    __slots__ = ("index", "codes", "letters", "starts", "cells", "db_bytes")

    def __init__(self, index, flat, lengths, starts, db_residues,
                 letters=LETTERS):
        cut = np.cumsum(lengths)[:-1]
        self.index = index
        self.codes = np.split(flat, cut)
        text = ascii_letters(letters)[flat]
        self.letters = [a.tobytes() for a in np.split(text, cut)]
        self.starts = [int(s) for s in starts]
        self.cells = int(lengths.sum()) * int(db_residues)
        self.db_bytes = int(db_residues)


class QueryStream:
    """Queries of a traffic mix against a generated database.

    Call ``k`` of a stream takes the next ``queries_per_call`` lengths of
    the cycle.  Each query is a window of the concatenated database at a
    random start with a share ``residues.substitution`` of its positions
    redrawn uniformly over ``letters``: a homolog of the targets it
    overlaps, as a search query has in a real database.
    """

    def __init__(self, traffic, db_lengths, db_codes, seed, stream,
                 letters=LETTERS):
        self.cycle = query_lengths(traffic, db_lengths)
        self.per_call = int(traffic["queries_per_call"])
        self.residues = traffic["residues"]
        if self.residues["from"] != "database_window":
            raise ValueError(f"unknown residues: {self.residues!r}")
        self.db_codes = db_codes
        self.db_residues = int(db_codes.shape[0])
        self.seed = seed_key(seed)
        self.stream = stream
        self.letters = letters

    def lengths(self, k: int) -> list:
        n = len(self.cycle)
        first = k * self.per_call
        return [self.cycle[(first + i) % n] for i in range(self.per_call)]

    def call(self, k: int) -> Call:
        rng = np.random.default_rng([self.seed, self.stream, k])
        lens = np.array(self.lengths(k), dtype=np.int64)
        total = int(lens.sum())
        span = self.db_residues - lens + 1
        starts = (rng.random(lens.shape[0]) * span).astype(np.int64)
        first = np.concatenate(([0], np.cumsum(lens)[:-1]))
        at = np.repeat(starts - first, lens) + np.arange(total)
        flat = self.db_codes[at]
        redraw = rng.random(total) < float(self.residues["substitution"])
        flat[redraw] = rng.integers(
            0, len(self.letters), int(redraw.sum()), dtype=np.uint8
        )
        return Call(k, flat, lens, starts, self.db_residues, self.letters)

    def distinct_shapes(self) -> int:
        """Calls that cover every distinct set of lengths of the cycle."""
        n = len(self.cycle)
        seen, k = set(), 0
        while True:
            key = tuple(sorted(self.lengths(k)))
            if key in seen or k >= n:
                return max(k, 1)
            seen.add(key)
            k += 1
