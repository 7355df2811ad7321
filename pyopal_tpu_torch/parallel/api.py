"""User-facing sharded database search.

Port of ``pyopal_tpu/parallel/api.py``.  The reference's user-visible
parallelism knob is ``align(threads=N)``: a thread pool over database
chunks.  Here the axis is a mesh of database shards over cards, or over
the ranks of a `torch.distributed` group, with the same contract:
sharding never changes scores, and results come back keyed by global
target index:

>>> import pyopal_tpu_torch as pt
>>> from pyopal_tpu_torch.parallel import align_arrays_sharded, device_mesh
>>> db = pt.Database(["AACCGCTG", "ATGCGCT", "TTATTACG"])
>>> mesh = device_mesh(2, device="cpu")
>>> out = align_arrays_sharded(["ACCTG"], db, gap_open=2, mesh=mesh)
>>> out["scores"][0].tolist()
[41, 31, 23]

`align_arrays_sharded` is the mesh analog of
`pyopal_tpu_torch.Aligner.align_arrays`: the encoded database is dealt
over the shards (greedy-LPT balanced blocks), query profiles are copied
to every shard's device, each query-tier cohort runs the flat kernels
once on every shard, and the per-shard outputs are all-gathered and
reassembled into global target order.

In full mode the score+ends pass runs on the mesh and the traceback (T1,
T2) on this rank's first shard device.  `align_top_k_sharded` is the
mesh analog of `pyopal_tpu_torch.Aligner.align_top_k`: a per-shard top-k
candidate selection, a small candidate gather, an exact host merge, and
the traceback of the winners.

The port has one route.  On a CPU mesh the same dispatch runs the
kernels' plain versions, as the port's engine does; the reference's
second route for meshes off the TPU (``_xla_mesh_scores``, l.86), which
exists because interpreted Pallas is slow there, is not ported: its
top-k candidate pipeline runs on CPU and CUDA meshes alike.
"""

from __future__ import annotations

import numpy as np

from ..aligner import Aligner, _clamp_slice
from ..ops import engine, packing, q8
from . import sharded_flat as sfm
from .mesh import device_mesh

__all__ = ["align_arrays_sharded", "align_top_k_sharded"]

UINT32_MAX = 0xFFFFFFFF


def _pack_sharded_cached(database, n_shards, lanes, local_shards, start,
                         end):
    """`pack_flat_sharded` memoized on the database mutation version (the
    contract of `packing.pack_database_slice_flat`), so repeat calls
    skip repacking and re-uploading the database, and skip even
    materializing the encoded sequences on a cache hit.

    ``local_shards`` (from `sharded_flat.local_shards_of_mesh`) keeps
    the packed payloads of a rank to its own shards."""
    cache = getattr(database, "_pack_cache", None)
    key = (
        "sharded", n_shards, lanes, tuple(local_shards), start, end,
        database.get_version(),
    )
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            return hit
    seqs = [database.get_encoded(i) for i in range(start, end)]
    packed = sfm.pack_flat_sharded(
        seqs, n_shards, lanes=lanes, local_shards=local_shards
    )
    packing._cache_put(cache, key, packed)
    return packed


def align_arrays_sharded(
    queries,
    database,
    *,
    scoring_matrix=None,
    gap_open: int = 3,
    gap_extend: int = 1,
    mode: str = "score",
    algorithm: str = "sw",
    start: int = 0,
    end: int = UINT32_MAX,
    mesh=None,
):
    """Columnar batch search sharded over a mesh of database shards.

    Identical semantics to `pyopal_tpu_torch.Aligner.align_arrays` (same
    scores and ends for every ``(query, target)`` pair, same empty-
    alignment ``-1`` sentinels), with the database distributed over
    ``mesh``.  Query-tier cohorts route exactly like the single-device
    engine: full groups of 8 same-tier queries take K2, the rest K1,
    each launched once per shard.  Calls outside the kernels' domain
    (matrix entries beyond ±256, DP values past the reference's 2**24
    window, negative gap parameters), empty queries, and queries beyond
    4096 residues keep the same results through the single-device engine
    on this rank's first shard device.  In a process group every rank
    calls this with the same arguments and receives the whole result.

    Arguments:
        queries: iterable of query sequences (`str`, `bytes`, …).
        database (`~pyopal_tpu_torch.BaseDatabase`): targets to score.
        scoring_matrix: a `~pyopal_tpu_torch.ScoringMatrix`, a matrix
            name, or `None` for BLOSUM50 (the `Aligner` defaults).
        gap_open (`int`): gap opening penalty.
        gap_extend (`int`): gap extension penalty.
        mode (`str`): ``"score"``, ``"end"`` or ``"full"``.
        algorithm (`str`): ``"nw"``, ``"hw"``, ``"ov"`` or ``"sw"``.
        start (`int`): Start offset in the database.
        end (`int`): End offset in the database.
        mesh (`~pyopal_tpu_torch.parallel.mesh.Mesh`): the shards
            (`None`: ``device_mesh()``, every visible card; pass
            ``device_mesh(n, device="cpu")`` to run on the CPU).

    Returns:
        `dict`: ``{"scores": (n_queries, n_targets) int32}`` plus, for
        ``mode="end"``, ``"query_ends"`` and ``"target_ends"``;
        ``mode="full"`` adds ``"query_starts"`` / ``"target_starts"`` and
        ``"cigars"`` exactly like `pyopal_tpu_torch.Aligner.align_arrays`.
    """
    # validation only: the searches run on the mesh's devices
    aligner = Aligner(
        scoring_matrix, gap_open=gap_open, gap_extend=gap_extend,
        device="cpu",
    )
    if mode not in ("score", "end", "full"):
        raise ValueError(f"invalid batch search mode: {mode!r}")
    if algorithm not in ("nw", "hw", "ov", "sw"):
        raise ValueError(f"invalid algorithm: {algorithm!r}")
    if database.alphabet != aligner.alphabet:
        raise ValueError(
            "database and score matrix have different alphabets"
        )
    if mesh is None:
        mesh = device_mesh()
    n_shards = mesh.n_shards
    local_shards = sfm.local_shards_of_mesh(mesh)
    home = mesh.devices[local_shards[0]]
    matrix = aligner.scoring_matrix.int_data()
    with_ends = mode != "score"

    queries_enc = [
        np.frombuffer(database.alphabet.encode(q), dtype=np.uint8)
        for q in queries
    ]
    nq = len(queries_enc)

    # the read lock is held for the whole search: the mutation-version
    # cache key and every packed snapshot below are only coherent while
    # writers are excluded
    with database.lock.read:
        start, end = _clamp_slice(database.get_size(), start, end)
        n = max(end - start, 0)

        if nq == 0 or n == 0:
            out = {"scores": np.zeros((nq, n), dtype=np.int32)}
            if with_ends:
                out["query_ends"] = np.full((nq, n), -1, np.int32)
                out["target_ends"] = np.full((nq, n), -1, np.int32)
            if mode == "full":
                out["query_starts"] = np.zeros((nq, n), np.int32)
                out["target_starts"] = np.zeros((nq, n), np.int32)
                out["cigars"] = np.empty((nq, n), dtype=object)
            return out

        # the shards launch K1 and K2 with ``safe_pad``: without it (a
        # 32-column matrix) every query takes the fallback
        route = engine.kernel_route(
            database, start, end, queries_enc, matrix, gap_open,
            gap_extend, algorithm, with_ends,
        )
        mesh_idx = route.kernel if route.safe_pad else []
        fb_idx = sorted(set(range(nq)).difference(mesh_idx))

        scores = np.zeros((nq, n), dtype=np.int32)
        q_ends = np.full((nq, n), -1, dtype=np.int32)
        t_ends = np.full((nq, n), -1, dtype=np.int32)

        mesh_queries = [queries_enc[i] for i in mesh_idx]

        def _pack(lanes):
            return _pack_sharded_cached(
                database, n_shards, lanes, local_shards, start, end
            )

        def _store(qidx_rows, s, qe, te):
            for row, qi in qidx_rows:
                scores[qi] = s[row]
                if with_ends:
                    q_ends[qi] = qe[row]
                    t_ends[qi] = te[row]

        for _, lanes_q8, groups, v2_idx in engine.plan_tier_launches(
            mesh_queries, safe_pad=True
        ):
            # the single-device engine's launch quanta and its memoized
            # profile stacks
            for k0 in range(0, len(groups), engine._Q8_LAUNCH_GROUPS):
                gs = groups[k0 : k0 + engine._Q8_LAUNCH_GROUPS]
                profs, qv, maxq = engine._profiles_q8(
                    mesh_queries, matrix, gs, lanes_q8, home
                )
                s, qe, te = sfm.sharded_search_flat_q8(
                    mesh, profs, qv, maxq, _pack(lanes_q8), gap_open,
                    gap_extend, algorithm, with_ends=with_ends,
                )
                _store(
                    [
                        (g * q8.QB + qb, mesh_idx[qi])
                        for g, idxs in enumerate(gs)
                        for qb, qi in enumerate(idxs)
                    ],
                    s, qe, te,
                )

            if v2_idx:
                cohort = [mesh_queries[i] for i in v2_idx]
                profs, qlens = engine._profiles_for_cohort(
                    cohort, matrix, home
                )
                s, qe, te = sfm.sharded_search_flat(
                    mesh, profs, qlens, _pack(sfm.LANES), gap_open,
                    gap_extend, algorithm, with_ends=with_ends,
                    safe_pad=True, m_abs=route.m_abs,
                )
                _store(
                    [(row, mesh_idx[qi]) for row, qi in enumerate(v2_idx)],
                    s, qe, te,
                )

        if fb_idx:
            s, qe, te = engine.search_scores_batch(
                database, start, end, [queries_enc[i] for i in fb_idx],
                matrix, gap_open, gap_extend, algorithm,
                with_ends=with_ends, device=home,
            )
            _store(list(enumerate(fb_idx)), s, qe, te)

        if mode == "full":
            q_starts, t_starts, cigars = engine.full_arrays_from_ends(
                database, start, end, queries_enc, matrix, gap_open,
                gap_extend, algorithm, (scores, q_ends, t_ends),
                device=home,
            )

    out = {"scores": scores}
    if with_ends:
        out["query_ends"] = q_ends
        out["target_ends"] = t_ends
    if mode == "full":
        out["query_starts"] = q_starts
        out["target_starts"] = t_starts
        out["cigars"] = cigars
    return out


def _merge_topk_host(v, gi, qec, tec, k, m, shard_counts):
    """Exact global top-k from per-shard candidates, one query.

    ``v``/``gi``/``qec``/``tec``: ``(n_shards * m,)`` candidate rows
    from `sharded_flat.sharded_topk_candidates` (shard s occupies
    slots ``[s*m, (s+1)*m)``, sorted by descending score; invalid
    slots carry ``gi < 0``).  Selection reproduces the single-device
    `Aligner.align_top_k` contract bit-for-bit: descending score, ties
    by ascending global target index.

    Returns ``(indices, scores, q_ends, t_ends, complete)`` where
    ``complete`` is False when some shard's candidate floor touches
    the k-th score while the shard was truncated — the caller then
    escalates ``m`` and retries (`align_top_k_sharded`).
    """
    valid = gi >= 0
    vv, gg = v[valid], gi[valid]
    qq, tt = qec[valid], tec[valid]
    kk = min(k, gg.shape[0])
    if kk == 0:
        return (
            np.zeros(0, np.int64),
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
            True,
        )
    order = np.lexsort((gg, -vv))[:kk]
    s_k = int(vv[order[-1]])
    complete = True
    n_shards = len(shard_counts)
    for s in range(n_shards):
        row_v = v[s * m : (s + 1) * m]
        row_g = gi[s * m : (s + 1) * m]
        cnt = int((row_g >= 0).sum())
        if cnt == m and m < shard_counts[s] and int(row_v[cnt - 1]) >= s_k:
            # the shard was truncated at or above the k-th score: it
            # may hide equal-scoring targets with smaller indices
            complete = False
            break
    return gg[order], vv[order], qq[order], tt[order], complete


def align_top_k_sharded(
    queries,
    database,
    *,
    k: int = 100,
    scoring_matrix=None,
    gap_open: int = 3,
    gap_extend: int = 1,
    algorithm: str = "sw",
    start: int = 0,
    end: int = UINT32_MAX,
    mesh=None,
):
    """Full alignments of each query's ``k`` best targets, mesh-wide.

    The distributed form of `pyopal_tpu_torch.Aligner.align_top_k`: one
    score+ends pass over the database shards (K1 once per shard per
    query-tier cohort), a per-shard top-k selection with an ``O(k *
    n_shards)`` candidate gather (the full ``(n_queries, n_targets)``
    score matrix is never gathered), then batched traceback of only the
    winners on this rank's first shard device.  Results carry global
    ``target_index`` and match `align_top_k` exactly (descending score,
    ties by database order; the merge escalates the per-shard candidate
    count when score ties straddle a shard's candidate floor, to every
    shard's whole list: at most two candidate gathers per cohort).
    Empty queries, queries beyond 4096 residues and calls outside the
    kernels' domain go through `engine.search_top_k` on that device.

    Arguments match `align_arrays_sharded` plus ``k``; returns one
    `list` of `~pyopal_tpu_torch.FullResult` (sorted by descending
    score, at most ``k`` long) per query.
    """
    aligner = Aligner(
        scoring_matrix, gap_open=gap_open, gap_extend=gap_extend,
        device="cpu",
    )
    if algorithm not in ("nw", "hw", "ov", "sw"):
        raise ValueError(f"invalid algorithm: {algorithm!r}")
    if k < 0:
        raise ValueError(f"invalid k: {k!r}")
    if database.alphabet != aligner.alphabet:
        raise ValueError(
            "database and score matrix have different alphabets"
        )
    if mesh is None:
        mesh = device_mesh()
    n_shards = mesh.n_shards
    local_shards = sfm.local_shards_of_mesh(mesh)
    home = mesh.devices[local_shards[0]]
    matrix = aligner.scoring_matrix.int_data()

    queries_enc = [
        np.frombuffer(database.alphabet.encode(q), dtype=np.uint8)
        for q in queries
    ]
    nq = len(queries_enc)
    out = [[] for _ in range(nq)]

    with database.lock.read:
        start, end = _clamp_slice(database.get_size(), start, end)
        n = max(end - start, 0)
        if nq == 0 or n == 0 or k == 0:
            return out

        # the shards take K4/K5 where ``safe_pad`` fails
        route = engine.kernel_route(
            database, start, end, queries_enc, matrix, gap_open,
            gap_extend, algorithm, True,
        )
        mesh_idx = route.kernel
        fb_idx = sorted(set(range(nq)).difference(mesh_idx))

        if mesh_idx:
            sf = _pack_sharded_cached(
                database, n_shards, sfm.LANES, local_shards, start, end
            )
            shard_counts = np.bincount(
                sf.inv_shard, minlength=n_shards
            ).tolist()
            gidx = sfm._gidx_device(sf, mesh)

            # tier cohorts (one kernel launch per distinct Q_pad a shard)
            mesh_queries = [queries_enc[i] for i in mesh_idx]
            for _, _, _, v2_idx in engine.plan_tier_launches(
                mesh_queries, safe_pad=False
            ):
                qidx = [mesh_idx[j] for j in v2_idx]
                cohort = [mesh_queries[j] for j in v2_idx]
                profs, qlens = engine._profiles_for_cohort(
                    cohort, matrix, home
                )
                outs = sfm.sharded_search_flat_device(
                    mesh, profs, qlens, sf, gap_open, gap_extend, algorithm,
                    with_ends=True, safe_pad=route.safe_pad,
                )
                m = max(1, min(k, max(shard_counts)))
                pending = list(range(len(qidx)))
                while pending:
                    v, gi, qec, tec = sfm.sharded_topk_candidates(
                        mesh, outs, gidx, m
                    )
                    still = []
                    for row in pending:
                        sel = _merge_topk_host(
                            v[row], gi[row], qec[row], tec[row],
                            k, min(m, v.shape[1] // n_shards),
                            shard_counts,
                        )
                        idxs, scores, qes, tes, complete = sel
                        if not complete and m < max(shard_counts):
                            still.append(row)
                            continue
                        out[qidx[row]] = engine._full_results_for(
                            database, idxs + start, cohort[row], matrix,
                            gap_open, gap_extend, algorithm,
                            (scores, qes, tes), home,
                        )
                    pending = still
                    # escalation is tie-driven and rare: go straight to
                    # the complete-by-construction gather (every shard's
                    # whole candidate list) instead of doubling; at most
                    # two candidate gathers per cohort, and the second
                    # merge cannot be incomplete
                    m = max(shard_counts)

        for i in fb_idx:
            out[i] = engine.search_top_k(
                database, queries_enc[i], matrix, gap_open, gap_extend,
                algorithm, k, start, end, device=home,
            )
    return out
