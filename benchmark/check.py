"""The comparison that decides ``correct``.

The answers of a call are the scores of every query against every
target, in end mode also each answer's query and target end, and, where
the API returns result objects, each result's target index.  Once the
window has closed, the check takes calls of the window drawn from the
seed (always the last one) and, in each, the answers of every query at
the targets the traffic names: all of them, or a sample
drawn from the seed with one target in each of as many equal strata of
the length-sorted database, together with every target that a query's
homologous window overlaps (its best hits).  A plain reference scores
the same queries against the same generated database: `sw` in score
mode `reference.sw_scores`, every other algorithm and end mode
`reference_dp.search`.  The numbers compared are counts, each with the
limit 0:

- ``score_mismatches``: checked answers whose score differs;
- ``end_mismatches``: checked answers whose query end or target end
  differs (end-mode cells only);
- ``index_mismatches``: results missing, extra, or carrying another
  target index than their position's (result objects only);
- ``failed_calls``: calls of the window that raised.

The cell's algorithm is its traffic's ``options.algorithm``, which has
to be its configuration's ``scoring.algorithm``; its mode is
``options.mode``, score or end (`judged`).
"""

from __future__ import annotations

import numpy as np

from . import generate, reference, reference_dp

LIMITS = {
    "score_mismatches": 0, "end_mismatches": 0, "index_mismatches": 0,
    "failed_calls": 0,
}
#: the API's arrays each mode is judged by, as ``align_arrays`` names
#: them, and the result objects' attributes that hold them
PLANES = {
    "score": (("scores", "score"),),
    "end": (("scores", "score"), ("query_ends", "query_end"),
            ("target_ends", "target_end")),
}


def judged(traffic, scoring):
    """``(algorithm, mode)`` of a cell, from its traffic's options (the
    API's defaults, ``sw`` and ``score``, where it gives none).  Raises
    `ValueError` where the check cannot judge the cell: the traffic runs
    another algorithm than the configuration states, or a mode other
    than score or end."""
    options = traffic.get("options", {})
    algorithm = options.get("algorithm", "sw")
    mode = options.get("mode", "score")
    if algorithm != scoring["algorithm"]:
        raise ValueError(
            f"the traffic runs algorithm {algorithm!r}, the configuration "
            f"states {scoring['algorithm']!r}"
        )
    if mode not in PLANES:
        raise ValueError(
            f"the check judges modes {sorted(PLANES)}, the traffic runs "
            f"mode {mode!r} (algorithm {algorithm!r})"
        )
    return algorithm, mode


def answers(result, n_queries: int, n_targets: int, mode: str = "score"):
    """``(planes, index_mismatches)`` of an API result: the mode's planes
    (`PLANES`) as a ``(P, n_queries, n_targets)`` int64 array, or None
    where the result has another shape or the call raised."""
    names = PLANES[mode]
    shape = (n_queries, n_targets)
    if result is None:
        return None, n_queries * n_targets
    if isinstance(result, dict):
        planes = [np.asarray(result.get(key)) for key, _ in names]
        if any(p.shape != shape for p in planes):
            return None, n_queries * n_targets
        return np.stack(planes).astype(np.int64), 0
    rows = [result] if n_queries == 1 else list(result)
    if len(rows) != n_queries:
        return None, n_queries * n_targets
    planes = np.zeros((len(names),) + shape, dtype=np.int64)
    bad = 0
    for qi, hits in enumerate(rows):
        hits = list(hits)
        bad += abs(len(hits) - n_targets)
        idx = np.fromiter((h.target_index for h in hits), np.int64, len(hits))
        m = min(len(hits), n_targets)
        bad += int((idx[:m] != np.arange(m)).sum())
        for p, (_, attr) in enumerate(names):
            got = np.fromiter((getattr(h, attr) for h in hits), np.int64, len(hits))
            planes[p, qi, :m] = got[:m]
    return planes, bad


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
    def __init__(self, mode: str = "score"):
        self.numbers = {
            name: 0 for name in LIMITS
            if mode == "end" or name != "end_mismatches"
        }
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


def reference_planes(call, data, scoring, targets, mode, device):
    """The plain reference's planes of one call at ``targets``,
    ``(P, n_queries, len(targets))``: `reference.sw_scores` for ``sw`` in
    score mode, `reference_dp.search` for everything else."""
    args = (
        call.codes, data.codes, data.offsets, data.lengths, targets,
        scoring["table"], scoring["gap_open"], scoring["gap_extend"],
    )
    if scoring["algorithm"] == "sw" and mode == "score":
        return reference.sw_scores(*args, device=device)[None]
    return reference_dp.search(
        *args, algorithm=scoring["algorithm"], ends=mode == "end",
        device=device,
    )


def compare(kept, data, scoring, spec, seed, device, failed, program=None,
            mode="score"):
    """Judge the kept calls, ``[(call, result)]``, against the reference
    of the configuration's algorithm in ``mode``.

    ``program`` replaces the kept results by another function of
    ``(call, targets)`` that returns the mode's planes at those targets
    (in score mode the scores alone will do): the control puts the
    reference in lower precision there.
    """
    verdict = Verdict(mode)
    verdict.numbers["failed_calls"] = int(failed)
    n_t = data.lengths.shape[0]
    targets = sample_targets(
        spec, data.lengths, data.offsets, [c for c, _ in kept], seed
    )
    for call, result in kept:
        nq = len(call.codes)
        ref = reference_planes(call, data, scoring, targets, mode, device)
        if program is not None:
            got = np.asarray(program(call, targets)).reshape(ref.shape)
            bad = 0
        else:
            planes, bad = answers(result, nq, n_t, mode)
            got = None if planes is None else planes[:, :, targets]
        verdict.numbers["index_mismatches"] += int(bad)
        n_checked = ref[0].size
        if got is None:
            verdict.numbers["score_mismatches"] += n_checked
            if mode == "end":
                verdict.numbers["end_mismatches"] += n_checked
        else:
            verdict.numbers["score_mismatches"] += int((got[0] != ref[0]).sum())
            if mode == "end":
                verdict.numbers["end_mismatches"] += int(
                    (got[1:] != ref[1:]).any(axis=0).sum()
                )
        verdict.answers_checked += n_checked
        verdict.calls_checked += 1
    return verdict
