"""The comparison that decides ``correct``.

The answers of a call are the scores of every query against every
target, and, where the API returns result objects, each result's target
index.  Once the window has closed, the check takes calls of the window
drawn from the seed (always the last one) and, in each, the answers of
every query at the targets the traffic names: all of them, or a sample
drawn from the seed with one target in each of as many equal strata of
the length-sorted database, together with every target that a query's
homologous window overlaps (its best hits).  The plain reference
(`reference.sw_scores`) scores the same queries against the same
generated database; the numbers compared are counts, each with the
limit 0:

- ``score_mismatches``: checked answers whose score differs;
- ``index_mismatches``: results missing, extra, or carrying another
  target index than their position's (result objects only);
- ``failed_calls``: calls of the window that raised.
"""

from __future__ import annotations

import numpy as np

from . import generate, reference

LIMITS = {"score_mismatches": 0, "index_mismatches": 0, "failed_calls": 0}


def answers(result, n_queries: int, n_targets: int):
    """``(scores, index_mismatches)`` of an API result: scores as an
    ``(n_queries, n_targets)`` int64 array, or None where the result has
    another shape or the call raised."""
    if result is None:
        return None, n_queries * n_targets
    if isinstance(result, dict):
        scores = np.asarray(result.get("scores"))
        if scores.shape != (n_queries, n_targets):
            return None, n_queries * n_targets
        return scores.astype(np.int64), 0
    rows = [result] if n_queries == 1 else list(result)
    if len(rows) != n_queries:
        return None, n_queries * n_targets
    scores = np.zeros((n_queries, n_targets), dtype=np.int64)
    bad = 0
    for qi, hits in enumerate(rows):
        hits = list(hits)
        bad += abs(len(hits) - n_targets)
        idx = np.fromiter((h.target_index for h in hits), np.int64, len(hits))
        sc = np.fromiter((h.score for h in hits), np.int64, len(hits))
        m = min(len(hits), n_targets)
        bad += int((idx[:m] != np.arange(m)).sum())
        scores[qi, :m] = sc[:m]
    return scores, bad


def checked_calls(n_calls_expected: int, n_check: int, seed: int) -> set:
    """Indices of the window's calls to keep for the check, besides the
    last: ``n_check - 1`` drawn from the seed among the calls expected."""
    rng = np.random.default_rng(
        [generate.seed_key(seed), generate.STREAM_CHECK, 0]
    )
    n = max(int(n_calls_expected), 1)
    k = min(max(n_check - 1, 0), n)
    return {int(x) for x in rng.choice(n, size=k, replace=False)}


def sample_targets(spec, db_lengths, db_offsets, calls, seed) -> np.ndarray:
    """The targets whose answers are compared (sorted indices)."""
    n = db_lengths.shape[0]
    if spec == "all":
        return np.arange(n)
    rng = np.random.default_rng(
        [generate.seed_key(seed), generate.STREAM_CHECK, 1]
    )
    strata = min(int(spec["sample"]), n)
    by_len = np.argsort(db_lengths, kind="stable")
    edges = np.linspace(0, n, strata + 1).astype(np.int64)
    picks = by_len[edges[:-1] + (rng.random(strata) * np.diff(edges)).astype(np.int64)]
    chosen = [picks]
    if spec.get("include_sources"):
        ends = db_offsets + db_lengths
        for call in calls:
            for start, q in zip(call.starts, call.codes):
                stop = start + q.shape[0]
                lo = int(np.searchsorted(ends, start, side="right"))
                hi = int(np.searchsorted(db_offsets, stop, side="left"))
                chosen.append(np.arange(lo, hi))
    return np.unique(np.concatenate(chosen))


class Verdict:
    def __init__(self):
        self.numbers = {name: 0 for name in LIMITS}
        self.answers_checked = 0
        self.calls_checked = 0

    @property
    def correct(self) -> bool:
        return self.answers_checked > 0 and all(
            v <= LIMITS[k] for k, v in self.numbers.items()
        )

    def lines(self):
        return [f"check {k} {v} limit {LIMITS[k]}" for k, v in self.numbers.items()]

    def as_json(self):
        return {k: {"value": v, "limit": LIMITS[k]} for k, v in self.numbers.items()}


def compare(kept, data, scoring, spec, seed, device, failed, program=None):
    """Judge the kept calls, ``[(call, result)]``, against the reference.

    ``program`` replaces the kept results' scores by another function of
    ``(call, targets) -> scores``: the control puts the reference in
    lower precision there.
    """
    verdict = Verdict()
    verdict.numbers["failed_calls"] = int(failed)
    n_t = data.lengths.shape[0]
    targets = sample_targets(
        spec, data.lengths, data.offsets, [c for c, _ in kept], seed
    )
    for call, result in kept:
        nq = len(call.codes)
        ref = reference.sw_scores(
            call.codes, data.codes, data.offsets, data.lengths, targets,
            scoring["table"], scoring["gap_open"], scoring["gap_extend"],
            device=device,
        )
        if program is not None:
            got = program(call, targets)
            bad = 0
        else:
            scores, bad = answers(result, nq, n_t)
            got = None if scores is None else scores[:, targets]
        verdict.numbers["index_mismatches"] += int(bad)
        if got is None:
            verdict.numbers["score_mismatches"] += ref.size
        else:
            verdict.numbers["score_mismatches"] += int((got != ref).sum())
        verdict.answers_checked += ref.size
        verdict.calls_checked += 1
    return verdict
