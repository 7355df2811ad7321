"""Search dispatcher: packs the database slice and runs the kernels.

Port of ``pyopal_tpu/ops/engine.py``:
`search_scores_batch` (l.577), `search_scores`, `search` (l.995),
`plan_tier_launches` (l.271) with its constants, the cohort dispatch
(`_search_batch_pallas`, l.347, here `_search_batch_kernels`), the
long-query dispatch (`_search_long_pallas`, l.690, here
`_search_long_kernels`), the result assembly (`_assemble_flat*`),
`_empty_query_results`, `_fp32_exact_domain` and the profile cache;
and full mode: `_full_rows_for` with its kernel-score guard (l.802),
`_full_results_for` (l.830), `search_full_batch` (l.858),
`full_arrays_from_ends` (l.904) and `search_top_k` (l.943), which run the
score+ends pass and then the traceback of `ops.traceback` (T1, T2).

Routing is decided before any launch and never after a failure;
`kernel_route` draws the kernels' domain for the engine and for
`parallel`'s sharded entry points alike:

- calls inside the reference's kernel predicate (matrix entries within
  +-256 and the exact-value domain of `_fp32_exact_domain`, which also
  excludes negative gap penalties) take the kernels, exactly as the
  reference routes them.  With a matrix of at most 31 columns
  (``safe_pad``: the pad symbol 31 scores `PAD_SCORE`), queries of
  1..4096 residues go by query-tier cohort: full groups of 8 same-tier
  queries (tiers 64-512) to the q8 kernel (K2), the rest to the ragged
  kernel (K1), as `plan_tier_launches` splits them in both packages.  In
  sw score mode a q8 group takes K2 on the packed walk of K7 (two slots
  in int16 halves) wherever `_packed_exact_domain` proves that no
  intermediate leaves int16, and K2's int32 walk otherwise; a K1
  launch of a wave of blocks or more likewise takes K1's packed route
  (two target lanes a walk) where `_ragged_packed_cap` proves it under
  rows = min(Q_pad, longest target).  A longer query goes alone: one K1
  launch at its fine tier where `ragged.supports_fine` admits it, else
  the segmented kernel (K3, `ragged_long`), one launch per 2048 rows.
- with a 32-column matrix (no ``safe_pad``) there is no q8 group and no
  fine tier: each query-tier cohort takes one `ragged.search_flat`
  launch, K5 (strips of 256 rows) in score mode at tiers 512-4096 and K4
  otherwise up to tier 2048; a query beyond what `ragged.supports`
  admits (ends beyond 2048 residues, any mode beyond 4096) takes K3.
- on CUDA these are the hand-written kernels; on the CPU the same
  dispatch runs their plain versions.
- everything else takes the int32 column sweep (`ops.sweep`), on the
  same device: empty queries get `_empty_query_results`.

Results are assembled into global target order on the device and come
back to the host in one copy per launch (per long query).

While a `torch.profiler` runs, the stages open ``pyopal.*`` spans and
add to the counters of `pyopal_tpu_torch.utils.profiling`: the cells
each kernel launch needed and walked, the bytes copied back, profile
cache hits and misses.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..results import (
    FullResult,
    build_end_results,
    build_score_results,
    cigar_string,
)
from ..utils.profiling import count, counting, span, spanned
from . import packing, q8, ragged, ragged_long, sweep, traceback


def _flat_device(fp: packing.FlatPacked, device: torch.device):
    """Device tensors of a flat pack, cached on the pack per device."""
    cache = fp.__dict__.setdefault("_dev", {})
    key = str(device)
    dev = cache.get(key)
    if dev is None:
        dev = tuple(
            torch.as_tensor(np.ascontiguousarray(a)).to(device)
            for a in (
                fp.flat_targets,
                fp.lengths,
                fp.block_of_step,
                fp.chunk_of_step,
                fp.last_of_step,
                fp.inv_pos.astype(np.int64),
            )
        )
        cache[key] = dev
    return dev


def _slice_maxlen(database, start, end) -> int:
    """Longest target in ``database[start:end)``, memoized on the
    database mutation version."""
    cache_d = getattr(database, "_pack_cache", None)
    key = (database.get_version(), start, end)
    side = getattr(database, "_tmax_cache", None)
    if side is None and cache_d is not None:
        side = database.__dict__.setdefault("_tmax_cache", {})
    if side is not None:
        hit = side.get(key)
        if hit is not None:
            return hit
    lengths = database.get_lengths()
    t_max = int(max((lengths[i] for i in range(start, end)), default=0))
    if side is not None:
        if len(side) > 1024:
            side.clear()
        side[key] = t_max
    return t_max


def _count_cells(qlens, fp: packing.FlatPacked, walks, pairs=False):
    """Count one launch's cells: ``cells.needed``, the ``qlens`` query
    residues times the slice's residues, and ``cells.walked``, what the
    kernel's walks step through: for each ``(rows, G)`` walk its rows in
    whole passes times the pack's steps at ``G`` (`ragged.walk_rows`,
    `ragged.walk_steps`, with ``pairs`` for K1's packed route, whose
    warps step two lanes a group; the steps are kept on the pack).  The
    engine launches at gaps >= 0 only (`_fp32_exact_domain`), where every
    walk stops at its query's length."""
    if not counting():
        return
    steps = fp.__dict__.setdefault("_walk_steps", {})
    walked = 0
    for rows, G in walks:
        if (G, pairs) not in steps:
            steps[G, pairs] = ragged.walk_steps(fp.lengths, G, pairs)
        walked += ragged.walk_rows(rows, G) * steps[G, pairs]
    count("cells.needed", sum(qlens) * fp.total_cells)
    count("cells.walked", walked)


def _copy_back(dev_out):
    """A launch's assembled outputs as a host array (blocks on the
    device)."""
    with span("pyopal.copyback"):
        count("copyback.bytes", dev_out.numel() * dev_out.element_size())
        return dev_out.cpu().numpy()


@spanned("pyopal.assemble")
def _assemble_flat(inv_pos, s, qe, te, with_ends):
    """Reorder ragged-kernel outputs ``(n_q, n_blocks, lanes)`` into
    global target order."""
    nq = s.shape[0]

    def one(x):
        return x.reshape(nq, -1).index_select(1, inv_pos)

    scores = one(s)
    if not with_ends:
        return scores
    return torch.stack([scores, one(qe), one(te)], dim=1)


@spanned("pyopal.assemble")
def _assemble_flat_q8(inv_pos, s, qe, te, with_ends):
    """Reorder q8-kernel outputs ``(n_g, n_blocks, QB, lanes)`` into
    per-slot rows in global target order (row = g * QB + qb; padding
    slots are skipped by the caller)."""
    n_g, n_blocks, qb, lanes = s.shape

    def one(x):
        flat = x.permute(0, 2, 1, 3).reshape(n_g * qb, -1)
        return flat.index_select(1, inv_pos)

    scores = one(s)
    if not with_ends:
        return scores
    return torch.stack([scores, one(qe), one(te)], dim=1)


# --- query profile memoization ---------------------------------------------

_PROFILE_CACHE: dict = {}
_PROFILE_CACHE_MAX = 64
# align(threads>=2) runs engine code from ThreadPool workers holding
# only the shared read lock; cache mutation needs its own guard
_PROFILE_CACHE_LOCK = threading.Lock()


def _cached(key, make):
    with _PROFILE_CACHE_LOCK:
        hit = _PROFILE_CACHE.get(key)
    if hit is not None:
        count("profile.hits", 1)
        return hit
    count("profile.misses", 1)
    out = make()
    with _PROFILE_CACHE_LOCK:
        while len(_PROFILE_CACHE) >= _PROFILE_CACHE_MAX:
            _PROFILE_CACHE.pop(next(iter(_PROFILE_CACHE)))
        _PROFILE_CACHE[key] = out
    return out


@spanned("pyopal.profile")
def _profiles_for_cohort(cohort, matrix, device):
    """Device-resident stacked profiles + query lengths, memoized."""
    key = (
        str(device),
        b"".join(q.tobytes() + b"\xff" for q in cohort),
        matrix.tobytes(),
    )

    def make():
        profs = ragged.make_profiles_host(cohort, matrix)
        qlens = np.array([len(q) for q in cohort], np.int32)
        return (
            torch.as_tensor(profs).to(device),
            torch.as_tensor(qlens).to(device),
        )

    return _cached(key, make)


@spanned("pyopal.profile")
def _profiles_q8(queries_enc, matrix, groups, lanes, device):
    """Device-resident q8 profile stack (+qv/maxq), memoized."""
    key = (
        "q8",
        str(device),
        lanes,
        b"".join(
            queries_enc[i].tobytes() + b"\xff" for g in groups for i in g
        ),
        matrix.tobytes(),
    )

    def make():
        arrays = q8.make_profiles_q8_host(
            queries_enc, matrix, groups, lanes=lanes
        )
        return tuple(torch.as_tensor(a).to(device) for a in arrays)

    return _cached(key, make)


#: q8 lane width by query tier; tiers beyond 512 stay on the ragged
#: kernel (the reference's routing, kept so both packages agree)
_Q8_LANES_BY_TIER = {64: 512, 128: 512, 256: 512, 512: 256}

#: leftover-cohort size at which a partial q8 group replaces a ragged
#: launch (the reference's constant)
_Q8_PARTIAL_MIN = 6

#: q8 groups (of 8 queries) per kernel launch
_Q8_LAUNCH_GROUPS = 8


def plan_tier_launches(queries_enc, safe_pad):
    """Plan kernel routing for a query batch.

    Queries are grouped into cohorts by profile tier (padded query
    length); within each tier, full groups of `q8.QB` queries take the
    q8 kernel when the tier has a q8 lane route and ``safe_pad`` holds,
    and the remainder takes the ragged kernel.

    Returns a list of ``(tier, lanes_q8, q8_groups, v2_idx)`` sorted by
    tier: ``q8_groups`` is a list of QB-length lists of query indices
    (empty when nothing routes to q8), ``v2_idx`` the leftover indices.
    """
    cohorts: dict = {}
    for i, q in enumerate(queries_enc):
        tier = ragged.profile_qpad(max(len(q), 8))
        cohorts.setdefault(tier, []).append(i)

    plan = []
    for tier, qidx in sorted(cohorts.items()):
        lanes_q8 = _Q8_LANES_BY_TIER.get(tier) if safe_pad else None
        q8_idx, v2_idx = [], qidx
        if lanes_q8 is not None:
            order = sorted(qidx, key=lambda i: -queries_enc[i].shape[0])
            m = (len(order) // q8.QB) * q8.QB
            if len(order) - m >= _Q8_PARTIAL_MIN:
                m = len(order)
            q8_idx, v2_idx = order[:m], order[m:]
        groups = [
            q8_idx[k : k + q8.QB] for k in range(0, len(q8_idx), q8.QB)
        ]
        plan.append((tier, lanes_q8, groups, v2_idx))
    return plan


@spanned("pyopal.pack")
def _packed(database, start, end, device, **kw):
    """A slice's flat pack and its device tensors (`_flat_device`)."""
    fp = packing.pack_database_slice_flat(database, start, end, **kw)
    return fp, _flat_device(fp, device)


def _search_batch_kernels(
    database, start, end, queries_enc, matrix, go, ge, algorithm,
    with_ends, device, safe_pad, m_abs,
):
    """Kernel route: one launch per query-tier cohort (q8 launches of
    up to `_Q8_LAUNCH_GROUPS` groups, on the packed walk where
    `_packed_exact_domain` holds for the matrix's largest absolute entry
    ``m_abs``, then a ragged launch for the leftovers, on K1's packed
    route where `_ragged_packed_cap` gives a cap; without ``safe_pad``
    the ragged launch alone)."""
    nq = len(queries_enc)
    n = max(end - start, 0)
    launches = []  # (device tensor, row -> query-index list)

    with span("pyopal.route"):
        plan = plan_tier_launches(queries_enc, safe_pad)
    for _, lanes_q8, groups, v2_idx in plan:
        if groups:
            fpw, (flat_t, lengths, bos, cos, los, inv_pos) = _packed(
                database, start, end, device, lanes=lanes_q8
            )
            for k in range(0, len(groups), _Q8_LAUNCH_GROUPS):
                gs = groups[k : k + _Q8_LAUNCH_GROUPS]
                profs, qv, maxq = _profiles_q8(
                    queries_enc, matrix, gs, lanes_q8, device
                )
                q_pad = profs.shape[1] // q8.QB
                cap = (
                    q_pad * m_abs
                    if _packed_exact_domain(
                        algorithm, with_ends, go, ge, m_abs, q_pad
                    )
                    else None
                )
                s, qe, te = q8.search_flat_q8(
                    profs, qv, maxq, flat_t, lengths, bos, cos, los,
                    int(go), int(ge), algorithm, with_ends,
                    chunk=fpw.chunk, packed_cap=cap,
                )
                # slot lengths; an empty slot of a partial group is 0
                qlens = [
                    len(queries_enc[g[k]]) if k < len(g) else 0
                    for g in gs for k in range(q8.QB)
                ]
                G = ragged.wave_group(q_pad)
                if cap is None:  # each slot walks its own rows
                    count("q8.groups_wide", len(gs))
                    walks = [(q, G) for q in qlens]
                else:  # both slots of a pair walk the longer one's rows
                    count("q8.groups_packed", len(gs))
                    walks = [
                        (max(qlens[k], qlens[k + 1]), G)
                        for k in range(0, len(qlens), 2) for _ in range(2)
                    ]
                _count_cells(qlens, fpw, walks)
                launches.append((
                    _assemble_flat_q8(inv_pos, s, qe, te, with_ends),
                    [qi for g in gs for qi in g],
                ))
        if v2_idx:
            cohort = [queries_enc[i] for i in v2_idx]
            fp, (flat_t, lengths, bos, cos, los, inv_pos) = _packed(
                database, start, end, device
            )
            profs, qlens = _profiles_for_cohort(cohort, matrix, device)
            cap = _ragged_packed_cap(
                algorithm, with_ends, go, ge, m_abs, profs.shape[1],
                _slice_maxlen(database, start, end), safe_pad, len(cohort),
                fp.lengths.size,
            )
            s, qe, te = ragged.search_flat(
                profs, qlens, flat_t, lengths, bos, cos, los,
                int(go), int(ge), algorithm, with_ends, chunk=fp.chunk,
                safe_pad=safe_pad, packed_cap=cap,
            )
            G = ragged.wave_group(profs.shape[1])
            _count_cells(
                [len(q) for q in cohort], fp, [(len(q), G) for q in cohort],
                pairs=cap is not None,
            )
            launches.append((
                _assemble_flat(inv_pos, s, qe, te, with_ends),
                list(v2_idx),
            ))

    with span("pyopal.scatter"):
        scores = np.zeros((nq, n), dtype=np.int32)
        q_ends = np.full((nq, n), -1, dtype=np.int32)
        t_ends = np.full((nq, n), -1, dtype=np.int32)
    for dev_out, order in launches:
        block = _copy_back(dev_out)
        with span("pyopal.scatter"):
            for pos, qi in enumerate(order):
                if with_ends:
                    scores[qi] = block[pos, 0]
                    q_ends[qi] = block[pos, 1]
                    t_ends[qi] = block[pos, 2]
                else:
                    scores[qi] = block[pos]
    return scores, q_ends, t_ends


def _sweep_targets(fp: packing.FlatPacked, device):
    """``(T_max, N)`` symbol matrix + lengths + inverse positions of a
    flat pack for the sweep route, cached on the pack per device."""
    cache = fp.__dict__.setdefault("_sweep", {})
    key = str(device)
    hit = cache.get(key)
    if hit is None:
        flat_t, lengths, bos, _, _, inv_pos = _flat_device(fp, device)
        cols = sweep.columns_from_flat(flat_t, lengths, bos, fp.chunk)
        hit = (cols, lengths.reshape(-1), inv_pos)
        cache[key] = hit
    return hit


def _search_batch_sweep(
    database, start, end, queries_enc, matrix, go, ge, algorithm, device
):
    """Sweep route: one `sweep.search` per query over the flat pack."""
    fp = packing.pack_database_slice_flat(database, start, end)
    cols, lengths, inv_pos = _sweep_targets(fp, device)
    out = []
    for q in queries_enc:
        prof = torch.as_tensor(sweep.make_profile_t(q, matrix)).to(device)
        s, qe, te = sweep.search(
            prof[None], [q.shape[0]], cols, lengths, go, ge, algorithm
        )
        block = torch.stack([s[0], qe[0], te[0]]).index_select(1, inv_pos)
        out.append(_copy_back(block))
    return out


#: the reference kernels carry H/E in fp32, exact within (-2**24, 2**24);
#: the port keeps the same predicate so both packages route alike
_FP32_EXACT_BOUND = 2**24


def _fp32_exact_domain(
    database, start, end, queries_enc, matrix, gap_open, gap_extend
) -> bool:
    """Whether every DP intermediate of this call fits the reference
    kernels' fp32 exact-integer window (static, conservative bound)."""
    if gap_open < 0 or gap_extend < 0:
        return False
    t_max = _slice_maxlen(database, start, end)
    q_max = int(max((q.shape[0] for q in queries_enc), default=0))
    m_max = int(np.abs(matrix).max(initial=0))
    span = q_max + t_max
    bound = span * m_max + gap_open + span * gap_extend
    q_pad_bound = max(2 * q_max, q_max + 512, 64)
    worst = bound + gap_open + q_pad_bound * min(gap_open, gap_extend)
    return worst < _FP32_EXACT_BOUND


def _packed_exact_domain(algorithm, with_ends, gap_open, gap_extend, m_abs,
                         rows) -> bool:
    """Whether a launch may take the packed walk with H's cap at ``rows *
    m_abs`` and return the int32 walk's exact scores (static; no device
    work): sw score mode, matrix entries within the walk's staging clamp
    (``m_abs``, the largest absolute entry), and gaps and cap within
    `ragged.packed_fits`: both gaps >= 0 within the floor's reach, every
    intermediate in int16.  ``rows`` bounds the diagonal moves of any
    local alignment: a q8 group's tier ``Q_pad`` (``csrc/q8_narrow.cu``),
    or min(``Q_pad``, longest target) for K1's packed route
    (`_ragged_packed_cap`).  No sw cell exceeds ``rows * m_abs``, so the
    cap never binds."""
    return (
        algorithm == "sw"
        and not with_ends
        and m_abs <= ragged.WAVE_CLAMP
        and ragged.packed_fits(int(gap_open), int(gap_extend), rows * m_abs)
    )


#: K1's packed route walks two lanes a group, so its launch has half of
#: K1's blocks; below one wave of the H100 (132 SMs, two 256-thread
#: blocks each) it ran slower than K1's int32 walk (one query on 12,071
#: lanes at the 128 tier: 190 blocks, 0.89x; from 380 blocks it wins;
#: PERF.md §6)
_PACKED_MIN_BLOCKS = 2 * 132


def _ragged_packed_cap(algorithm, with_ends, gap_open, gap_extend, m_abs,
                       q_pad, t_max, safe_pad, n_q, n_lanes):
    """H's cap for a `ragged.search_flat` launch of ``n_q`` queries at
    tier ``q_pad`` over ``n_lanes`` target lanes whose longest target is
    ``t_max`` (host data: no device sync), or None for K1's int32 walk.
    K1's packed route (``csrc/ragged_packed.cu``) needs ``safe_pad`` (its
    pad symbol) and `_packed_exact_domain` with rows = min(``q_pad``,
    ``t_max``), and then returns K1's scores; it is taken where its
    launch fills `_PACKED_MIN_BLOCKS` blocks."""
    rows = min(q_pad, t_max)
    pairs = ragged.WAVE_THREADS // ragged.wave_group(q_pad)  # a block's
    blocks = n_q * -(-n_lanes // (2 * pairs))
    if (safe_pad and blocks >= _PACKED_MIN_BLOCKS and _packed_exact_domain(
            algorithm, with_ends, gap_open, gap_extend, m_abs, rows)):
        return rows * m_abs
    return None


class KernelRoute(NamedTuple):
    """A call's queries by route (`kernel_route`), as indices into its
    query list in input order."""

    safe_pad: bool  # the matrix leaves pad symbol 31 unused
    m_abs: int  # the matrix's largest absolute entry (the packed caps)
    kernel: list  # inside the domain, admitted by `ragged.supports`
    long: list  # inside the domain, refused by `ragged.supports`
    sweep: list  # nonempty, outside the domain
    empty: list  # no residues


def kernel_route(database, start, end, queries_enc, matrix, gap_open,
                 gap_extend, algorithm, with_ends) -> KernelRoute:
    """The kernels' domain, for every entry point (`search_scores_batch`,
    `parallel.align_arrays_sharded`, `parallel.align_top_k_sharded`).

    A call is inside the domain when its matrix entries are within
    +-256 and `_fp32_exact_domain` holds (the reference's predicate);
    ``safe_pad`` holds when the matrix has at most 31 columns, so that
    the pad symbol 31 scores `ragged.PAD_SCORE` for every query row."""
    m_abs = int(np.abs(matrix).max(initial=0))
    inside = m_abs <= 256 and _fp32_exact_domain(
        database, start, end, queries_enc, matrix, gap_open, gap_extend
    )
    safe_pad = matrix.shape[1] <= 31
    route = KernelRoute(safe_pad, m_abs, [], [], [], [])
    for i, q in enumerate(queries_enc):
        if q.shape[0] == 0:
            route.empty.append(i)
        elif not inside:
            route.sweep.append(i)
        elif ragged.supports(q.shape[0], algorithm, with_ends, safe_pad):
            route.kernel.append(i)
        else:
            route.long.append(i)
    return route


def search_scores_batch(
    database,
    start: int,
    end: int,
    queries_enc,
    matrix: np.ndarray,
    gap_open: int,
    gap_extend: int,
    algorithm: str,
    with_ends: bool = True,
    device="cuda",
):
    """Multi-query search over ``database[start:end)`` on ``device``.

    Returns ``(scores, q_ends, t_ends)`` numpy arrays of shape
    ``(n_queries, n_targets)`` each, in slice-local target order.
    Must be called with the database read lock held.
    """
    device = torch.device(device)
    n = end - start
    nq = len(queries_enc)
    if n <= 0 or nq == 0:
        z = np.zeros((nq, max(n, 0)), dtype=np.int32)
        return z, z.copy(), z.copy()

    queries_enc = [np.asarray(q, dtype=np.uint8) for q in queries_enc]
    with span("pyopal.route"):
        route = kernel_route(
            database, start, end, queries_enc, matrix, gap_open,
            gap_extend, algorithm, with_ends,
        )

    with span("pyopal.scatter"):
        scores = np.zeros((nq, n), dtype=np.int32)
        q_ends = np.full((nq, n), -1, dtype=np.int32)
        t_ends = np.full((nq, n), -1, dtype=np.int32)

    if route.kernel:
        s, qe, te = _search_batch_kernels(
            database, start, end, [queries_enc[i] for i in route.kernel],
            matrix, gap_open, gap_extend, algorithm, with_ends, device,
            route.safe_pad, route.m_abs,
        )
        with span("pyopal.scatter"):
            for k, i in enumerate(route.kernel):
                scores[i], q_ends[i], t_ends[i] = s[k], qe[k], te[k]

    for i in route.long:
        scores[i], q_ends[i], t_ends[i] = _search_long_kernels(
            database, start, end, queries_enc[i], matrix, gap_open,
            gap_extend, algorithm, with_ends, device, route.safe_pad,
            route.m_abs,
        )

    if route.sweep:
        blocks = _search_batch_sweep(
            database, start, end, [queries_enc[i] for i in route.sweep],
            matrix, gap_open, gap_extend, algorithm, device,
        )
        for i, block in zip(route.sweep, blocks):
            scores[i], q_ends[i], t_ends[i] = block

    for i in route.empty:
        scores[i], q_ends[i], t_ends[i] = _empty_query_results(
            database, start, end, gap_open, gap_extend, algorithm
        )
    return scores, q_ends, t_ends


def _search_long_kernels(
    database, start, end, query_enc, matrix, go, ge, algorithm, with_ends,
    device, safe_pad, m_abs,
):
    """One query beyond what `ragged.supports` admits: a single K1 launch
    at its fine tier (`ragged.fine_qpad`) where ``safe_pad`` holds and
    `ragged.supports_fine` admits it, on K1's packed route where
    `_ragged_packed_cap` gives a cap, else the segmented kernel K3
    (`ragged_long.search_flat_long`).

    Returns the three result planes as numpy arrays in slice-local
    target order, copied back in one transfer.
    """
    fp, (flat_t, lengths, bos, cos, los, inv_pos) = _packed(
        database, start, end, device
    )
    Q = int(query_enc.shape[0])
    if safe_pad and ragged.supports_fine(Q, algorithm, with_ends):
        q_pad = ragged.fine_qpad(Q)
        with span("pyopal.profile"):
            count("profile.misses", 1)  # one query alone: no cache
            profs = torch.as_tensor(
                ragged.make_profiles_host([query_enc], matrix, q_pad=q_pad)
            ).to(device)
            qlens = torch.tensor([Q], dtype=torch.int32, device=device)
        cap = _ragged_packed_cap(
            algorithm, with_ends, go, ge, m_abs, q_pad,
            _slice_maxlen(database, start, end), True, 1, fp.lengths.size,
        )
        s, qe, te = ragged.search_flat(
            profs, qlens, flat_t, lengths, bos, cos, los, int(go), int(ge),
            algorithm, with_ends, chunk=fp.chunk, safe_pad=True,
            packed_cap=cap,
        )
        walks = [(Q, ragged.wave_group(q_pad))]
    else:
        s, qe, te = ragged_long.search_flat_long(
            query_enc, matrix, flat_t, lengths, bos, cos, los, int(go),
            int(ge), algorithm, with_ends, chunk=fp.chunk,
        )
        # one walk a segment, its group size by the segment's rows
        qseg = ragged_long.QSEG
        walks = [
            (min(qseg, Q - r), ragged.wave_group(min(qseg, Q - r)))
            for r in range(0, Q, qseg)
        ]
        cap = None
    _count_cells([Q], fp, walks, pairs=cap is not None)
    with span("pyopal.assemble"):
        planes = torch.stack(
            [s.reshape(-1), qe.reshape(-1), te.reshape(-1)]
        ).index_select(1, inv_pos)
    return tuple(_copy_back(planes))


def search_scores(
    database,
    start: int,
    end: int,
    query_enc: np.ndarray,
    matrix: np.ndarray,
    gap_open: int,
    gap_extend: int,
    algorithm: str,
    with_ends: bool = True,
    device="cuda",
):
    """Single-query search; see `search_scores_batch`."""
    s, qe, te = search_scores_batch(
        database, start, end, [query_enc], matrix, gap_open, gap_extend,
        algorithm, with_ends=with_ends, device=device,
    )
    return s[0], qe[0], te[0]


def _empty_query_results(database, start, end, go, ge, algorithm):
    n = end - start
    lengths = np.asarray(
        database.get_lengths()[start:end], dtype=np.int64
    )
    if algorithm == "nw":
        scores = np.where(lengths > 0, -(go + (lengths - 1) * ge), 0)
        t_ends = (lengths - 1).astype(np.int32)
    else:
        scores = np.zeros(n, dtype=np.int64)
        t_ends = np.full(n, -1, np.int32)
    return scores.astype(np.int32), np.full(n, -1, np.int32), t_ends


def _full_rows_for(
    database, indices, query_enc, matrix, go, ge, algorithm, ends, device
):
    """Raw full-alignment rows for ``indices`` (global) given a score
    pass: ``(targets, rows)`` where ``rows[k]`` is the
    ``(score, q_start, t_start, q_end, t_end, ops)`` tuple for
    ``indices[k]``, cross-checked against the kernel score.

    ``ends`` holds per-selected-target ``(scores, q_ends, t_ends)``
    1-D arrays aligned with ``indices``.
    """
    targets = [database.get_encoded(int(i)) for i in indices]
    outs = traceback.full_alignments_batch(
        query_enc, targets, matrix, go, ge, algorithm, ends, device=device
    )
    for k, row in enumerate(outs):
        if row[0] != int(ends[0][k]):
            # a kernel/traceback divergence is exactly the bug class
            # this guard exists for; it must fire under -O too
            raise RuntimeError(
                f"traceback score {row[0]} != kernel score "
                f"{int(ends[0][k])} for target {int(indices[k])}"
            )
    return targets, outs


def _full_results_for(
    database, indices, query_enc, matrix, go, ge, algorithm, ends, device
):
    """`FullResult` objects for ``indices`` (global) given a score pass.

    ``ends`` holds per-selected-target ``(scores, q_ends, t_ends)``
    1-D arrays aligned with ``indices``.
    """
    Q = int(query_enc.shape[0])
    targets, outs = _full_rows_for(
        database, indices, query_enc, matrix, go, ge, algorithm, ends,
        device,
    )
    return [
        FullResult(
            int(indices[k]), score, qe, te, qs, ts, Q,
            int(targets[k].shape[0]), ops,
        )
        for k, (score, qs, ts, qe, te, ops) in enumerate(outs)
    ]


def search_full_batch(
    database,
    start: int,
    end: int,
    queries_enc,
    matrix: np.ndarray,
    gap_open: int,
    gap_extend: int,
    algorithm: str,
    device="cuda",
):
    """Batched ``mode="full"`` search: one score+ends pass over
    ``database[start:end)`` for every query, then per-query batched
    traceback of every target.

    Returns one `FullResult` list per query.  Must be called with the
    database read lock held.
    """
    scores, q_ends, t_ends = search_scores_batch(
        database, start, end, queries_enc, matrix, gap_open, gap_extend,
        algorithm, with_ends=True, device=device,
    )
    indices = np.arange(start, end)
    return [
        _full_results_for(
            database, indices, queries_enc[qi], matrix, gap_open,
            gap_extend, algorithm, (scores[qi], q_ends[qi], t_ends[qi]),
            device,
        )
        for qi in range(len(queries_enc))
    ]


def full_arrays_from_ends(
    database, start, end, queries_enc, matrix, go, ge, algorithm, ends,
    device="cuda",
):
    """Columnar ``mode="full"`` assembly from a score+ends pass.

    ``ends`` is ``(scores, q_ends, t_ends)``, each of shape
    ``(n_queries, end - start)``.  Returns the extra full-mode arrays:
    ``query_starts``/``target_starts`` int32 arrays of the same shape
    (``0`` for empty alignments, matching the reference's
    zero-initialized start locations) and ``cigars``, an object array
    of SAM CIGAR strings (`None` for empty alignments, like
    `FullResult.cigar`).  Must be called with the read lock held.
    """
    scores, q_ends, t_ends = ends
    nq, n = scores.shape
    q_starts = np.zeros((nq, n), dtype=np.int32)
    t_starts = np.zeros((nq, n), dtype=np.int32)
    cigars = np.empty((nq, n), dtype=object)
    indices = np.arange(start, end)
    for qi in range(nq):
        _, rows = _full_rows_for(
            database, indices, queries_enc[qi], matrix, go, ge, algorithm,
            (scores[qi], q_ends[qi], t_ends[qi]), device,
        )
        for k, (_, qs, ts, _, _, ops) in enumerate(rows):
            q_starts[qi, k] = qs
            t_starts[qi, k] = ts
            cigars[qi, k] = cigar_string(ops)
    return q_starts, t_starts, cigars


def search_top_k(
    database,
    query_enc: np.ndarray,
    matrix: np.ndarray,
    gap_open: int,
    gap_extend: int,
    algorithm: str,
    k: int,
    start: int,
    end: int,
    device="cuda",
):
    """Two-phase top-k search: score+ends pass, then realign k hits.

    The reference's documented workflow (score pass -> top hits ->
    full-mode realign) as one call: one score+ends pass over the slice,
    the top ``k`` targets by score (ties broken by database order)
    selected on the host with a stable argsort, and only those realigned.
    Returns `FullResult` objects sorted by descending score;
    ``target_index`` stays global.  Must be called with the database
    read lock held.
    """
    n = max(end - start, 0)
    k = max(min(k, n), 0)
    if k == 0:
        return []
    scores, q_ends, t_ends = search_scores(
        database, start, end, query_enc, matrix, gap_open, gap_extend,
        algorithm, with_ends=True, device=device,
    )
    order = np.argsort(-scores, kind="stable")[:k]
    sel = (scores[order], q_ends[order], t_ends[order])
    return _full_results_for(
        database, order + start, query_enc, matrix, gap_open, gap_extend,
        algorithm, sel, device,
    )


def search(
    database,
    query_enc: np.ndarray,
    matrix: np.ndarray,
    gap_open: int,
    gap_extend: int,
    mode: str,
    algorithm: str,
    start: int,
    end: int,
    device="cuda",
):
    """Search over ``database[start:end)`` in ``mode``; returns result
    objects.  Must be called with the database read lock held."""
    scores, q_ends, t_ends = search_scores(
        database, start, end, query_enc, matrix, gap_open, gap_extend,
        algorithm, with_ends=(mode != "score"), device=device,
    )
    if mode == "score":
        with span("pyopal.results"):
            return build_score_results(start, scores)
    if mode == "end":
        with span("pyopal.results"):
            return build_end_results(start, scores, q_ends, t_ends)
    # mode == "full": the two-phase reconstruction, T1 and T2 over padded
    # batches of every target
    return _full_results_for(
        database, np.arange(start, end), query_enc, matrix, gap_open,
        gap_extend, algorithm, (scores, q_ends, t_ends), device,
    )
