"""Query-cohort kernels over the flat packed database (K1, K4, K5).

Port of ``pyopal_tpu/ops/pallas_ragged.py``: `search_flat` (l.1049)
with the three kernels it launches, `make_profiles_host` (l.155),
`profile_qpad` (l.105) and `supports` (l.80).  `search_flat` routes as
the reference does (l.1091-1107):

- ``safe_pad`` (the matrix leaves profile column 31, the pad symbol,
  unused: every bundled matrix): K1, `_ragged_kernel_v2` (l.400), every
  algorithm and mode (``csrc/ragged.cu``); with ``packed_cap`` (sw score
  mode, where the engine proves int16 exact) K1's packed route, two
  target lanes a walk in int16 halves (``csrc/ragged_packed.cu``);
- otherwise score-only at query tiers of `STRIP_MIN_QPAD` rows and more:
  K5, `_ragged_kernel_strip` (l.732), score planes only
  (``csrc/ragged_strip.cu``);
- otherwise tiers up to `RAGGED_MAX_QPAD`: K4, `_ragged_kernel` (l.169),
  both modes (``csrc/ragged_v1.cu``);
- anything else raises `ValueError`, as the reference does.

K4 and K5 answer over all ``Q_pad`` profile rows, pad rows included,
and K4 fills the score-mode end planes from untracked positions, as
their TPU kernels do (`sweep.sweep_all_rows`); K1 stops at the query's
length and writes -1 planes in score mode.  Each kernel is hand-written
CUDA C++, its design described in its source: all three give each query
x target lane a group of `wave_group` threads with 16 query rows each in
registers, walking the target as a wavefront (``csrc/wave.cuh``, shared
with K2, K3 and K6).  K4 and K5 walk the pad rows only where a gap is
negative: with both gaps >= 0 no path through a pad row can raise a
score or move an end (the proof is in ``csrc/ragged_v1.cu``).

Four things live here:

- `search_flat`, the wrapper: it checks its inputs, launches the routed
  CUDA kernel for CUDA tensors and counts it in `launches`; for CPU
  tensors it runs the kernel's plain version instead and counts it in
  `plain_calls` (both keyed by kernel).  A CUDA tensor never falls back.
- `search_flat_reference`, the plain PyTorch version of the same
  function, routed alike: a column sweep (`pyopal_tpu_torch.ops.sweep`)
  for K1, `search_flat_v1_reference` for K4 and
  `search_flat_strip_reference` for K5.
- `wave_reference`, `wave_v1_reference` and `wave_strip_reference`, K1,
  K4 and K5 as their kernels compute them (`wave_walk_reference`, the
  walk's CPU emulation, also K2's, K3's and K6's): for the tests, which
  hold them against the JAX package at small group sizes; no call path
  runs them.
- the host-side profiles and tier helpers shared with the engine,
  including the fine tiers of single long queries (`fine_qpad`,
  `supports_fine`, ``pallas_ragged.py`` l.113-152), which K1 takes in
  one launch.

Output semantics (all four algorithms, score-only or with ends) follow
the reference kernels exactly, including the empty-target values.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models import ALGORITHMS
from ..utils.profiling import count, spanned
from . import sweep

ALPHA = 32  # profile columns (MAX_ALPHABET_SIZE)
#: profile entries of rows past a query's length and of pad column 31
#: (the reference's ``pallas_kernel.PAD_SCORE``, as an integer)
PAD_SCORE = -4_000_000
#: the flat packing's pad symbol; it scores `PAD_SCORE` for every query
#: row only when the matrix has at most 31 columns (``safe_pad``)
PAD_SYMBOL = 31
#: largest query tier of K4 (reference ``RAGGED_MAX_QPAD``)
RAGGED_MAX_QPAD = 2048
#: largest power-of-two query tier of K1 and K5 (reference
#: ``RAGGED_MAX_QPAD_STRIP``); single long queries go beyond it at fine
#: tiers (`supports_fine`)
RAGGED_MAX_QPAD_STRIP = 4096
#: the reference K5's strip height (``STRIP``): one pass of the port's
#: K5 walk (``csrc/ragged_strip.cu``, G x R = 16 x 16 rows)
STRIP = 256
#: smallest query tier that K5 takes (reference ``STRIP_MIN_QPAD``)
STRIP_MIN_QPAD = 512
LANES = 128

ALGO_CODES = {"sw": 0, "nw": 1, "hw": 2, "ov": 3}
#: largest scratch (bytes) one kernel launch may use: the pass buffer of
#: K1, K2 and K4-K7 at tiers of several passes; a call that needs more is
#: split into launches over query and lane ranges
SCRATCH_BYTES = 2 << 30

#: kernel launches made by `search_flat` on CUDA tensors, by kernel
#: (`flat_route`'s names: K1, K4, K5; K1's packed route)
launches = {"ragged": 0, "ragged_v1": 0, "ragged_strip": 0,
            "ragged_packed": 0}
#: plain-version runs made by the wrapper on CPU tensors, by kernel
plain_calls = dict.fromkeys(launches, 0)


def supports(
    Q: int,
    algorithm: str = "sw",
    with_ends: bool = True,
    safe_pad: bool = False,
) -> bool:
    """Whether `search_flat` takes a query of length ``Q`` (the
    reference's `supports`, so both packages route alike).

    With ``safe_pad`` K1 serves every algorithm and mode up to
    `RAGGED_MAX_QPAD_STRIP`; without it K4 tops out at `RAGGED_MAX_QPAD`,
    and K5 takes score-only calls up to `RAGGED_MAX_QPAD_STRIP`.
    """
    del algorithm
    if not 0 < Q:
        return False
    if safe_pad:
        return Q <= RAGGED_MAX_QPAD_STRIP
    if Q <= RAGGED_MAX_QPAD:
        return True
    return (not with_ends) and Q <= RAGGED_MAX_QPAD_STRIP


def flat_route(q_pad: int, with_ends: bool, safe_pad: bool) -> str:
    """The kernel `search_flat` runs at a ``q_pad``-row tier: ``"ragged"``
    (K1), ``"ragged_strip"`` (K5) or ``"ragged_v1"`` (K4); raises
    `ValueError` where the reference does."""
    if safe_pad:
        return "ragged"
    if not with_ends and q_pad >= STRIP_MIN_QPAD:
        return "ragged_strip"
    if q_pad > RAGGED_MAX_QPAD:
        raise ValueError(
            f"query tier {q_pad} needs a strip-blocked path; use the "
            "segmented long-query kernel for end/full modes with "
            "32-letter matrices (see engine.search_scores_batch)"
        )
    return "ragged_v1"


def profile_qpad(Q: int) -> int:
    """Pad query length to a power-of-two tier (at least 64)."""
    tier = 64
    while tier < Q:
        tier *= 2
    return tier


#: fine-tier quantum for single long queries (reference ``FINE_QUANTUM``)
FINE_QUANTUM = 512

#: The reference's budget for a fine-tier launch: the TPU's 16 MB scoped
#: VMEM less headroom, in bytes.  Copied unchanged, like
#: `v2_scratch_bytes`, so that both packages route a long query alike and
#: their launch counts compare; it says nothing about the H100.
V2_FINE_BUDGET = 13_500_000


def fine_qpad(Q: int) -> int:
    """Pad a long query to the `FINE_QUANTUM` grid (at least one
    quantum) instead of a power of two."""
    return max(-(-Q // FINE_QUANTUM) * FINE_QUANTUM, FINE_QUANTUM)


def v2_scratch_bytes(Q_pad: int, algorithm: str, with_ends: bool) -> int:
    """Bytes of ``(Q_pad, LANES)`` scratch the reference kernel declares
    (H, E, and the trackers of the algorithm and mode)."""
    n = 2  # H, E
    if algorithm != "nw":
        n += 1  # best
        if with_ends:
            n += 1  # bestj
    if algorithm in ("nw", "ov"):
        n += 1  # cap
    return n * Q_pad * LANES * 4


def supports_fine(Q: int, algorithm: str, with_ends: bool) -> bool:
    """Whether a single long query takes one K1 launch at its fine tier;
    beyond this the segmented kernel (`ragged_long`) takes over."""
    if Q <= 0:
        return False
    need = v2_scratch_bytes(fine_qpad(Q), algorithm, with_ends)
    return need <= V2_FINE_BUDGET


def make_profiles_host(queries_enc, matrix, q_pad=None) -> np.ndarray:
    """Stacked ``(n_q, Q_pad, 32)`` int32 profiles at a common tier:
    the power-of-two tier of the longest query, or ``q_pad`` rows (a
    fine tier)."""
    qmax = max(len(q) for q in queries_enc)
    Q_pad = profile_qpad(max(qmax, 8)) if q_pad is None else q_pad
    profs = np.full((len(queries_enc), Q_pad, ALPHA), PAD_SCORE, np.int32)
    S = np.asarray(matrix, dtype=np.int32)
    for i, q in enumerate(queries_enc):
        q = np.asarray(q, dtype=np.int64)
        profs[i, : q.shape[0], : S.shape[1]] = S[q, :]
    return profs


def launch_plan(n_units, unit_rows, n_lanes, budget=None):
    """Split a kernel call into launches whose scratch fits ``budget``.

    A call covers ``n_units`` scratch units (queries, or q8 groups) of
    ``unit_rows`` rows each, over ``n_lanes`` target lanes; one (unit,
    lane) needs ``unit_rows`` scratch cells of 8 bytes (the pass buffer's
    H and F at a target column).  A launch takes every lane and as many
    units as fit, or one unit and a multiple of 128 lanes when all lanes
    do not fit (at least 128 lanes whatever the budget).  Returns
    ``(units, lanes, chunks)``: the scratch extent of one launch and its
    ``(unit0, unit1, lane0, lane1)`` ranges.
    """
    budget = SCRATCH_BYTES if budget is None else budget
    if n_units == 0 or n_lanes == 0:
        return 0, 0, []
    cap = max(budget // (8 * unit_rows), 128)  # (unit, lane) pairs
    if n_lanes <= cap:
        units, lanes = min(n_units, cap // n_lanes), n_lanes
    else:
        units, lanes = 1, cap // 128 * 128
    chunks = [
        (u, min(u + units, n_units), n, min(n + lanes, n_lanes))
        for u in range(0, n_units, units)
        for n in range(0, n_lanes, lanes)
    ]
    return units, lanes, chunks


def check_flat(flat_targets, lengths, bos, cos, los, device):
    """Validate the flat-pack tensors shared by both kernels."""
    for name, t, dt in (
        ("flat_targets", flat_targets, torch.uint8),
        ("lengths", lengths, torch.int32),
        ("bos", bos, torch.int32),
        ("cos", cos, torch.int32),
        ("los", los, torch.int32),
    ):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if flat_targets.ndim != 2 or lengths.ndim != 3 or lengths.shape[1] != 1:
        raise ValueError(
            "expected flat_targets (total_rows, lanes) and lengths "
            "(n_blocks, 1, lanes)"
        )
    lanes = flat_targets.shape[1]
    if lengths.shape[2] != lanes:
        raise ValueError("lengths and flat_targets disagree on lanes")
    if lanes % 128:
        raise ValueError(f"lanes must be a multiple of 128, got {lanes}")
    if not (bos.shape == cos.shape == los.shape) or bos.ndim != 1:
        raise ValueError("bos/cos/los must be 1-D maps of one length")


@spanned("pyopal.launch")
def search_flat(
    profs,
    qlens,
    flat_targets,
    lengths,
    bos,
    cos,
    los,
    go,
    ge,
    algorithm,
    with_ends,
    chunk=64,
    safe_pad=False,
    packed_cap=None,
):
    """Every query x the whole flat-packed database.

    Runs the kernel `flat_route` names: K1 under ``safe_pad``, else K5
    for score-only calls at tiers of `STRIP_MIN_QPAD` rows and more, else
    K4.  One kernel launch, or several where one launch's pass buffer (at
    tiers beyond one pass of the walk) would exceed `SCRATCH_BYTES`
    (`wave_buffer`); each adds one to the kernel's count in `launches`.
    While a profiler runs, K1's (query, target lane) walks are counted in
    ``ragged.walks_packed`` with ``packed_cap``, else ``ragged.walks_wide``.

    Arguments:
        profs: ``(n_q, Q_pad, 32)`` int32 profiles (`make_profiles_host`)
            at a power-of-two tier or, for one long query, a fine tier.
        qlens: ``(n_q,)`` int32 query lengths; K4 and K5 take lengths in
            ``[1, Q_pad]`` only.
        flat_targets: ``(total_rows, lanes)`` uint8 symbols.
        lengths: ``(n_blocks, 1, lanes)`` int32 target lengths.
        bos / cos / los: the layout's ``(n_steps,)`` int32 step maps.
        chunk: the layout's column-chunk quantum.
        safe_pad: whether the scoring matrix leaves profile column
            `PAD_SYMBOL` unused (at most 31 columns), as the reference's
            argument of that name; its default, False, is the reference's.
        packed_cap: with ``safe_pad``, in sw score mode, at gaps and a cap
            within `packed_fits` (else `ValueError`): K1's packed route
            (``launches["ragged_packed"]``), two target lanes a walk with
            H capped at ``packed_cap``, so min(sw score, ``packed_cap``)
            on every lane: K1's scores where no cell reaches the cap
            (`engine._ragged_packed_cap`).

    Returns:
        ``(scores, q_ends, t_ends)``, int32 of shape
        ``(n_q, n_blocks, lanes)``.
    """
    dev = profs.device
    check_flat(flat_targets, lengths, bos, cos, los, dev)
    if profs.dtype != torch.int32 or qlens.dtype != torch.int32:
        raise TypeError("profs and qlens must be int32")
    if profs.ndim != 3 or profs.shape[2] != ALPHA:
        raise ValueError(f"profs must be (n_q, Q_pad, {ALPHA})")
    n_q, q_pad, _ = profs.shape
    if qlens.shape != (n_q,) or qlens.device != dev:
        raise ValueError("qlens must be (n_q,) on the profiles' device")
    if not (profs.is_contiguous() and qlens.is_contiguous()):
        raise ValueError("profs and qlens must be contiguous")
    if algorithm not in ALGO_CODES:
        raise ValueError(f"invalid algorithm: {algorithm!r}")
    route = flat_route(q_pad, with_ends, safe_pad)
    if packed_cap is not None and not (
            route == "ragged" and algorithm == "sw" and not with_ends
            and packed_fits(int(go), int(ge), int(packed_cap))):
        raise ValueError(
            "packed_cap supports only sw score-only under safe_pad with "
            "gaps and a cap that keep every intermediate in int16 "
            "(packed_fits)"
        )
    if route == "ragged":  # K1: its walks by route
        count("ragged.walks_packed" if packed_cap is not None
              else "ragged.walks_wide", n_q * lengths.numel())
        if packed_cap is not None:
            route = "ragged_packed"
    elif n_q:
        lo, hi = (int(x) for x in torch.aminmax(qlens))
        if lo < 1 or hi > q_pad:
            raise ValueError(
                f"query lengths must lie in [1, {q_pad}] without safe_pad"
            )
    if dev.type == "cpu":
        plain_calls[route] += 1
        return search_flat_reference(
            profs, qlens, flat_targets, lengths, bos, cos, los,
            go, ge, algorithm, with_ends, chunk, safe_pad,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")

    from . import _cuda

    n_blocks, _, lanes = lengths.shape
    row_off = sweep.block_row_offsets(bos, n_blocks, chunk)
    outs = [
        torch.empty((n_q, n_blocks, lanes), dtype=torch.int32, device=dev)
        for _ in range(3)
    ]
    # the pass buffer of tiers beyond one pass of the walk
    pairs = packed_cap is not None
    chunks, buf = wave_buffer(n_q, 1, q_pad, flat_targets, n_blocks, pairs)
    for q0, q1, n0, n1 in chunks:  # one stream: launches reuse the buffer
        _cuda.launch(
            route,
            profs[q0:q1], qlens[q0:q1], flat_targets, lengths, row_off,
            *(o[q0:q1] for o in outs), buf,
            q1 - q0, q_pad, n_blocks, lanes, n0, n1 - n0, int(go), int(ge),
            ALGO_CODES[algorithm], int(bool(with_ends)),
            flat_targets.shape[0], wave_group(q_pad),
            *((int(packed_cap),) if pairs else ()),
        )
        launches[route] += 1
    return tuple(outs)


def search_flat_reference(
    profs,
    qlens,
    flat_targets,
    lengths,
    bos,
    cos,
    los,
    go,
    ge,
    algorithm,
    with_ends,
    chunk=64,
    safe_pad=False,
):
    """Plain PyTorch version of `search_flat` (same inputs, outputs, and
    route: `search_flat_v1_reference` for K4,
    `search_flat_strip_reference` for K5, a column sweep for K1 and for
    K1's packed route, which returns K1's scores)."""
    route = flat_route(profs.shape[1], with_ends, safe_pad)
    args = (profs, qlens, flat_targets, lengths, bos, cos, los, go, ge,
            algorithm)
    if route == "ragged_v1":
        return search_flat_v1_reference(*args, with_ends, chunk)
    if route == "ragged_strip":
        return search_flat_strip_reference(*args, chunk)
    n_q = profs.shape[0]
    n_blocks, _, lanes = lengths.shape
    targets = sweep.columns_from_flat(flat_targets, lengths, bos, chunk)
    s, qe, te = sweep.sweep_batch(
        profs, qlens, targets, lengths.reshape(-1), go, ge, algorithm
    )
    if not with_ends:
        qe = torch.full_like(s, -1)
        te = torch.full_like(s, -1)
    return tuple(x.reshape(n_q, n_blocks, lanes) for x in (s, qe, te))


def search_flat_v1_reference(
    profs,
    qlens,
    flat_targets,
    lengths,
    bos,
    cos,
    los,
    go,
    ge,
    algorithm,
    with_ends,
    chunk=64,
):
    """Plain version of K4: `sweep.sweep_all_rows` over the flat pack
    (every profile row, pad rows included; score-mode end planes as K4's
    finalize writes them)."""
    n_q = profs.shape[0]
    n_blocks, _, lanes = lengths.shape
    targets = sweep.columns_from_flat(flat_targets, lengths, bos, chunk)
    out = sweep.sweep_all_rows(
        profs, qlens, targets, lengths.reshape(-1), go, ge, algorithm,
        with_ends,
    )
    return tuple(x.reshape(n_q, n_blocks, lanes) for x in out)


def search_flat_strip_reference(
    profs,
    qlens,
    flat_targets,
    lengths,
    bos,
    cos,
    los,
    go,
    ge,
    algorithm,
    chunk=64,
):
    """Plain version of K5: K4's score-mode sweep over every profile row,
    with -1 in both end planes."""
    s, _, _ = search_flat_v1_reference(
        profs, qlens, flat_targets, lengths, bos, cos, los, go, ge,
        algorithm, False, chunk,
    )
    return s, torch.full_like(s, -1), torch.full_like(s, -1)


# --- the wavefront walk (csrc/wave.cuh) ---------------------------------

#: query rows per thread of the wavefront walk (``csrc/wave.cuh``: WAVE_R)
WAVE_R = 16
#: threads per (query, target) of the walk, at most (WAVE_MAX_G)
WAVE_MAX_G = 16
#: threads per CUDA block of every walk (WAVE_THREADS)
WAVE_THREADS = 256
#: the packed walk (``csrc/wave.cuh``, NARROW; K7 and K2's exact route):
#: E and F's floor in place of -infinity, the clamp of profile entries,
#: and K7's cap on H
WAVE_FLOOR = -512
WAVE_CLAMP = 1024
WAVE_CAP = 255


def packed_ranges(go: int, ge: int, cap: int) -> dict:
    """The range of each int16 intermediate of the packed walk at gaps
    ``go``, ``ge`` >= 0 with H capped at ``cap`` (``csrc/q8_narrow.cu``):
    s + go, E and F before and after a gap, G_diag + s + go, H before the
    cap, H - go, and G = min(H, cap) - go."""
    return {"s + go": (go - WAVE_CLAMP, go + WAVE_CLAMP),
            "E, F": (WAVE_FLOOR - ge, cap - go),
            "G_diag + s + go": (-WAVE_CLAMP, cap + WAVE_CLAMP),
            "H": (0, cap + WAVE_CLAMP),
            "H - go": (-go, cap + WAVE_CLAMP - go),
            "G": (-go, cap - go)}


def packed_fits(go: int, ge: int, cap: int) -> bool:
    """Whether the packed walk takes gaps ``go``, ``ge`` and H's cap
    ``cap``: both gaps >= 0 and within the floor's reach (``go + ge <=
    -WAVE_FLOOR``), and every range of `packed_ranges` inside int16."""
    return (go >= 0 and ge >= 0 and go + ge <= -WAVE_FLOOR and cap >= 0
            and all(-(2**15) <= lo and hi < 2**15
                    for lo, hi in packed_ranges(go, ge, cap).values()))


def wave_group(rows: int, R: int = WAVE_R) -> int:
    """Threads per (query, target) for walks of ``rows`` query rows: the
    least power of two, at least 2, whose passes of ``G * R`` rows cover
    ``min(rows, WAVE_MAX_G * R)``."""
    g = 2
    while g < WAVE_MAX_G and g * R < rows:
        g *= 2
    return g


def walk_rows(rows: int, G: int) -> int:
    """Query rows a walk of ``rows`` rows steps through: whole passes of
    ``G * WAVE_R`` rows, none for an empty walk (``csrc/wave.cuh``:
    wave_walk)."""
    return -(-rows // (G * WAVE_R)) * G * WAVE_R


def walk_steps(lengths, G: int, pairs: bool = False) -> int:
    """Steps of one pass of the wavefront walk, summed over target lanes.

    A group of ``G`` threads walks each lane (with ``pairs``, K1's packed
    route, each pair of lanes 2k, 2k + 1), and the ``32 // G`` lanes (64
    // G with ``pairs``) of a warp step together: to the warp's longest
    target, plus the ``G - 1`` steps of the wavefront's tail, rounded up
    to an even count; a warp of empty lanes takes none (``csrc/wave.cuh``:
    wave_walk).  ``lengths`` are a flat pack's lane lengths, in lane
    order; a launch's lanes start at a multiple of 128, so its warps are
    the pack's."""
    per_warp = 32 // G * (2 if pairs else 1)
    lanes = np.asarray(lengths).reshape(-1, per_warp)
    # lane by lane: an order faster than max(1) over a short axis
    longest = functools.reduce(np.maximum, lanes.T)
    steps = longest[longest > 0].astype(np.int64) + G - 1
    return int((steps + (steps & 1)).sum()) * per_warp


def wave_buffer_rows(q_pad: int, flat_rows: int, n_blocks: int) -> int:
    """Buffer rows per (query, lane) that K1, K4 and K5 need at a
    ``q_pad``-row tier, on average over the flat pack's lanes: 0 when the
    tier fits one pass of the walk, else the mean target columns of a lane
    (the buffer holds H and F of a pass's last row at each of them)."""
    if q_pad <= wave_group(q_pad) * WAVE_R:
        return 0
    return -(-flat_rows // max(n_blocks, 1))


def wave_buffer(n_units, slots, q_pad, flat_targets, n_blocks, pairs=False):
    """The pass buffer of a wavefront-walk call (K1, K2, K4, K5, K7) and
    its launches: ``(chunks, buffer)``.

    A unit (a query, or a q8 group of ``slots`` queries, or of ``slots``
    pairs of queries for K7's packed walk) needs H and F at every target
    column of each lane (``(slots, 2, total_rows, lanes)`` int32, laid
    out like the flat targets) when its ``q_pad`` rows take several
    passes of the walk; `launch_plan` then splits the call within
    `SCRATCH_BYTES`.  With ``pairs`` (K1's packed route) a pair of lanes
    shares one packed G and F: ``(slots, 2, total_rows, lanes // 2)``,
    half the bytes a lane.  One launch and no buffer (``0``, a null
    pointer to the kernel) when the tier fits one pass."""
    rows, lanes = flat_targets.shape
    cols = wave_buffer_rows(q_pad, rows, n_blocks)
    if not cols:
        return [(0, n_units, 0, n_blocks * lanes)], 0
    width = lanes // 2 if pairs else lanes
    units, _, chunks = launch_plan(n_units, -(-slots * cols * width // lanes),
                                   n_blocks * lanes)
    return chunks, torch.empty((units, slots, 2, rows, width),
                               dtype=torch.int32, device=flat_targets.device)


def _wave_first(a, b):
    """Where tracker ``a`` (score, column, row) comes before ``b``: score
    desc, column asc, row asc."""
    (as_, aj, ai), (bs, bj, bi) = a, b
    return (as_ > bs) | ((as_ == bs) & ((aj < bj) | ((aj == bj) & (ai < bi))))


def wave_walk_reference(prof_flat, prof_rows, walk_prof, row0, rows, Q,
                        tgt, lens, hb_in, fb_in, pbuf_h, pbuf_f, go, ge,
                        algorithm, with_ends, trk, G, R, seg_out,
                        interleave=1, pad_rows=False, narrow=False,
                        h_cap=WAVE_CAP, pair=False):
    """CPU emulation of ``csrc/wave.cuh``'s `wave_walk` over N walks.

    It mirrors the kernel: passes of ``G * R`` rows; within a pass the
    anti-diagonal wavefront (step ``s``: thread ``t`` on column ``s - t``)
    with each thread's ``R`` rows of ``G = H - go`` and ``E``, the row
    above handed from thread ``t`` to ``t + 1``, thread 0 reading the
    closed-form row 0 or the buffer above; per-thread trackers (sw's
    running max and, on a new maximum, the first of the thread's rows
    that holds it), joined per pass, across threads by xor butterfly and
    with the incoming tracker by (score desc, column asc, row asc); hw/ov
    and nw read the last row in the owning thread; rows past the walk are
    masked.  With ``pad_rows`` (the kernel's PAD_ROWS, K4, K5 and K6 at
    negative gaps) the walk's rows go past the query: sw and ov track
    them, and row ``Q - 1`` is read in whichever pass and thread hold it;
    where ``rows`` is not a multiple of ``R`` (PAD_TAIL) the final pass
    masks the rows past the walk, also when it holds row ``Q - 1``.
    With ``narrow`` (the packed walk, sw score-only, each walk one half
    of a register) E and F start from `WAVE_FLOOR`, profile entries are
    clamped into ``[-WAVE_CLAMP, WAVE_CLAMP]``, ``G = min(H, h_cap) -
    go`` (``h_cap``: `WAVE_CAP` for K7, a bound no cell reaches for K2's
    exact route), the tracker and the buffer hold G (``trk``'s best must
    then be ``-go``), and every intermediate is asserted to lie in its
    range of `packed_ranges`, inside int16.  With ``pair`` as well (K1's
    packed route) walks ``2k`` and ``2k + 1`` are the two halves of one
    walk over a pair of target lanes: both walk to the longer lane's
    length, and each reads `PAD_SYMBOL` past its own.
    Vectorized over walks and threads in torch (int64).

    Arguments (N walks, T columns):
        prof_flat: ``(n_prof * prof_rows * 32,)`` profile entries;
            ``walk_prof`` (N,) names each walk's profile.  With
            ``interleave`` k (K2's groups), profiles come in groups of k
            whose rows interleave: row i of profile p is row
            ``k * i + p % k`` of group ``p // k``.
        row0: global query row of walk row 0 (an int); ``rows`` / ``Q``:
            ``(N,)`` rows walked and query lengths.
        tgt: ``(T, N)`` symbols; ``lens``: ``(N,)`` target lengths.
        hb_in / fb_in: ``(T, N)`` H and F of row ``row0 - 1`` (read when
            ``row0 > 0``).
        pbuf_h / pbuf_f: ``(T, N)`` buffers between passes, updated in
            place; with ``seg_out`` they receive the walk's last row.
        trk: ``(5, N)`` incoming trackers (best, cap, bi, bj, ci).

    Returns the ``(5, N)`` trackers after the walk.
    """
    spec = ALGORITHMS[algorithm]
    sw, nw, ov = algorithm == "sw", algorithm == "nw", algorithm == "ov"
    hw_ov = algorithm in ("hw", "ov")
    pen_row, pen_col = spec.penalize_first_row, spec.penalize_first_col
    i64 = torch.int64
    NEG = sweep.NEG
    BIG = 2**31 - 1
    assert not narrow or (sw and not with_ends and not seg_out
                          and not pad_rows)
    assert not pair or (narrow and interleave == 1 and tgt.shape[1] % 2 == 0)
    go, ge = int(go), int(ge)
    FLOOR = WAVE_FLOOR if narrow else NEG  # E and F's -infinity
    if narrow:
        assert packed_fits(go, ge, h_cap)
        ranges = packed_ranges(go, ge, h_cap)

    def in16(x, what):  # narrow: an intermediate in its range
        lo, hi = ranges[what]
        assert int(x.min()) >= lo and int(x.max()) <= hi, (
            what, int(x.min()), int(x.max()))

    T, N = tgt.shape
    rows = rows.to(i64)
    Q = Q.to(i64)
    lens = lens.to(i64)
    tgt = tgt.to(i64)
    if pair:  # a pair walks to its longer lane, the shorter one on pads
        tgt = torch.where(torch.arange(T)[:, None] < lens, tgt, PAD_SYMBOL)
        lens = lens.reshape(-1, 2).amax(1).repeat_interleave(2)
    walk_prof = walk_prof.to(i64)
    prof_flat = torch.cat([prof_flat.to(i64), torch.full((ALPHA,), PAD_SCORE,
                                                         dtype=i64)])
    pad_row = prof_flat.shape[0] // ALPHA - 1  # index of the PAD row
    GR = G * R
    t_ = torch.arange(G, dtype=i64)[:, None]  # (G, 1)
    r_ = torch.arange(R, dtype=i64)

    def bnd(q):  # first-column boundary H of query row q >= 0
        return -(go + q * ge) if pen_col else torch.zeros_like(q)

    n_pass = torch.where(rows > 0, (rows + GR - 1) // GR, 0)
    last_base = torch.clamp(n_pass - 1, min=0) * GR
    own_last = torch.where(rows > 0, (rows - 1 - last_base) // R, 0)
    has_last = (rows > 0) & (row0 + rows == Q)
    # pad_rows: row Q - 1 (qlast of the walk) lies in pass pass_q,
    # thread own_q, row rq of it
    qlast = Q - 1 - row0
    has_q = (rows > 0) & (qlast >= 0) & (qlast < rows)
    pass_q = torch.where(has_q, qlast // GR, -1)
    own_q = torch.where(has_q, qlast % GR // R, 0)
    rq = torch.where(has_q, qlast % R, 0)
    best_in, cap_in, bi_in, bj_in, ci_in = (x.to(i64) for x in trk)

    zero = torch.zeros((G, N), dtype=i64)
    lb, lbj, cap = (x[None].expand(G, N).clone()
                    for x in (best_in, bj_in, cap_in))
    oc, oci = zero + NEG, zero + BIG
    sb, sbi, sbj = zero - (go if narrow else 0), zero - 1, zero - 1
    nsteps = int(lens.max()) + G - 1 if N and int(lens.max()) > 0 else 0
    for p in range(int(n_pass.max()) if N else 0):
        base = p * GR
        part = p < n_pass  # (N,) walks with this pass
        final = part & (p == n_pass - 1)
        q0 = row0 + base + t_ * R + zero  # (G, N) first global row
        nv = torch.clamp(row0 + rows - q0, 0, R) * part
        rl = torch.where(final, (rows - 1 - base) % R, R - 1)
        owner_t = torch.where(final, (rows - 1 - base) // R, G - 1)
        owner = t_ == owner_t  # (G, N)
        write_rows = ~final if not seg_out else part
        if pad_rows:  # the thread that holds row Q - 1 tracks it
            track = (t_ == own_q) & (p == pass_q)
            trk_rl = rq
        else:  # the pass's owner tracks the walk's last row
            track = owner & final & has_last
            trk_rl = rl
        top = base == 0 and row0 == 0
        bh, bf = (hb_in, fb_in) if base == 0 else (pbuf_h, pbuf_f)
        qr = q0[:, None, :] + r_[None, :, None]  # (G, R, N) global rows
        Gv = bnd(qr) - go
        E = torch.full((G, R, N), FLOOR, dtype=i64)
        gdiag = torch.where(q0 == 0, 0, bnd(q0 - 1)) - go
        out_g, out_f, out_sym = zero.clone(), zero + FLOOR, zero.clone()
        pb = sb.clone() if sw and not with_ends else zero.clone()
        pbi, pbj = zero - 1, zero - 1
        # profile row of each (thread, row, walk): walk-relative rows
        # past the profile score PAD_SCORE, as the kernel stages them
        prow = qr - row0
        rowi = torch.where(
            prow < prof_rows,
            (walk_prof // interleave * prof_rows + prow) * interleave
            + walk_prof % interleave, pad_row)
        for s in range(nsteps):
            if top:
                gtop = torch.full((N,), (-(go + s * ge) if pen_row else 0)
                                  - go, dtype=i64)
                ftop = torch.full((N,), FLOOR, dtype=i64)
            elif s < T:  # narrow: the buffer holds G
                gtop = bh[s].to(i64) - (0 if narrow else go)
                ftop = bf[s].to(i64)
            else:
                gtop, ftop = torch.full((N,), -go, dtype=i64), zero[0]
            sym0 = tgt[s] if s < T else zero[0]
            recv_g = torch.cat([gtop[None], out_g[:-1]])
            gup = recv_g
            f = torch.cat([ftop[None], out_f[:-1]])
            sym = torch.cat([sym0[None], out_sym[:-1]])
            out_sym = sym
            j = s - t_ + zero  # (G, N)
            act = (nv > 0) & (j >= 0) & (j < lens)
            if not bool(act.any()):
                continue
            pv = prof_flat[rowi * ALPHA + sym[:, None, :]]  # (G, R, N)
            if narrow:
                pv = pv.clamp(-WAVE_CLAMP, WAVE_CLAMP)
            pv = pv + go
            gd = gdiag
            Gn = torch.empty_like(Gv)
            best = pb
            En = torch.maximum(E - ge, Gv)  # E of every row: G of its left
            Fr = torch.empty_like(Gv)
            f_in = f
            for r in range(R):
                f = torch.maximum(f - ge, gup)
                Fr[:, r] = f
                h = torch.maximum(torch.maximum(gd + pv[:, r], En[:, r]), f)
                if sw:
                    h.clamp_(min=0)
                gd = Gv[:, r]
                gup = Gn[:, r] = (h.clamp(max=h_cap) if narrow else h) - go
            if narrow:  # every intermediate of the packed cell
                diag = torch.cat([gdiag[:, None], Gv[:, :-1]], 1) + pv
                hpre = torch.maximum(torch.maximum(diag, En), Fr).clamp(min=0)
                in16(pv, "s + go")
                for x in (E - ge, En, Fr,
                          torch.cat([f_in[:, None], Fr[:, :-1]], 1) - ge):
                    in16(x, "E, F")
                in16(diag, "G_diag + s + go")
                in16(hpre, "H")
                in16(hpre - go, "H - go")
                in16(Gn, "G")
            if sw:  # the running max over the thread's rows in the walk
                hs = torch.where(r_[None, :, None] < nv[:, None],
                                 Gn if narrow else Gn + go, sweep.NEG)
                best = torch.maximum(best, hs.amax(1))
            fq = Fr.gather(1, rl[None, None].expand(G, 1, N))[:, 0]
            E = torch.where(act[:, None], En, E)
            Gn = torch.where(act[:, None], Gn, Gv)
            new = act & (best > pb) if sw and with_ends else None
            if new is not None and bool(new.any()):
                hit = (r_[None, :, None] < nv[:, None]) & (
                    Gn == (best - go)[:, None])
                ri = hit.to(torch.uint8).argmax(1)  # the first such row
                pbi = torch.where(new, q0 + ri, pbi)
                pbj = torch.where(new, j, pbj)
            pb = torch.where(act, best, pb)
            if ov:
                at_end = act & (j == lens - 1)
                for r in range(R):
                    h = Gn[:, r] + go
                    upd = at_end & (r < nv) & (h > oc)
                    oc = torch.where(upd, h, oc)
                    oci = torch.where(upd, q0 + r, oci)
            gq = Gn.gather(1, rl[None, None].expand(G, 1, N))[:, 0]
            hq = gq if narrow else gq + go  # narrow: the buffer holds G
            own = act & owner
            ht = Gn.gather(1, trk_rl[None, None].expand(G, 1, N))[:, 0] + go
            if hw_ov:
                upd = act & track & (ht > lb)
                lb = torch.where(upd, ht, lb)
                lbj = torch.where(upd, j, lbj)
            if nw:
                cap = torch.where(act & track & (j == lens - 1), ht, cap)
            wr = own & write_rows
            if bool(wr.any()):
                tt, nn = wr.nonzero(as_tuple=True)
                pbuf_h[j[tt, nn], nn] = hq[tt, nn].to(pbuf_h.dtype)
                pbuf_f[j[tt, nn], nn] = fq[tt, nn].to(pbuf_f.dtype)
            out_g = torch.where(act, gup, out_g)
            out_f = torch.where(act, f, out_f)
            gdiag = torch.where(act, recv_g, gdiag)
            Gv = Gn
        if sw:
            if not with_ends:
                sb = torch.where(part, pb, sb)
            else:
                take = part & _wave_first((pb, pbj, pbi), (sb, sbj, sbi))
                sb, sbi, sbj = (torch.where(take, a, b) for a, b in
                                ((pb, sb), (pbi, sbi), (pbj, sbj)))

    # join the G threads' trackers (xor butterfly), then the incoming one
    best, bi, bj, ci = best_in, bi_in, bj_in, ci_in
    m = 1
    while m < G:
        x = torch.arange(G) ^ m
        if sw:
            o = (sb[x], sbj[x], sbi[x])
            take = (_wave_first(o, (sb, sbj, sbi)) if with_ends
                    else o[0] > sb)
            sb, sbj, sbi = (torch.where(take, a, b) for a, b in
                            zip(o, (sb, sbj, sbi)))
        if ov:
            o = (oc[x], oci[x])
            take = (o[0] > oc) | ((o[0] == oc) & (o[1] < oci))
            oc, oci = (torch.where(take, a, b) for a, b in zip(o, (oc, oci)))
        m *= 2
    if sw:
        if not with_ends:
            best = torch.maximum(best_in, sb[0])
        else:
            take = _wave_first((sb[0], sbj[0], sbi[0]), (best_in, bj_in, bi_in))
            best, bi, bj = (torch.where(take, a, b) for a, b in
                            ((sb[0], best_in), (sbi[0], bi_in),
                             (sbj[0], bj_in)))
    holder = own_q if pad_rows else own_last  # the thread of row Q - 1
    if ov:
        take = (oc[0] > cap_in) | ((oc[0] == cap_in) & (oci[0] < ci_in))
        cap = torch.where(take, oc[0], cap_in)
        ci = torch.where(take, oci[0], ci_in)
    elif nw:
        cap = cap.gather(0, holder[None])[0]
    else:
        cap = cap_in
    if hw_ov:
        best = lb.gather(0, holder[None])[0]
        bj = lbj.gather(0, holder[None])[0]
    return torch.stack([best, cap, bi, bj, ci])


def unpack_halves(lo, hi):
    """The halves of the packed register built from int64 ``lo`` and
    ``hi`` (the packed walk's trackers), as its finish reads them:
    sign-extended, a value outside int16 wrapped as in the register."""
    packed = ((lo & 0xFFFF) | ((hi & 0xFFFF) << 16)).to(torch.int32)
    return ((packed & 0xFFFF) ^ 0x8000) - 0x8000, packed >> 16


def wave_finish(trk, Q, lens, algorithm, with_ends, score_planes):
    """`dp_finish` of ``csrc/dp.cuh`` on ``(5, N)`` trackers: (score,
    query end, target end), with -1 end planes in score mode unless
    ``score_planes`` (K3)."""
    best, cap, bi, bj, ci = trk
    Q = Q.to(torch.int64)
    lens = lens.to(torch.int64)
    if not with_ends:
        bi = bj = ci = torch.full_like(best, -1)
    if algorithm == "sw":
        out = (best, bi, bj)
    elif algorithm == "nw":
        out = (cap, Q - 1, lens - 1)
    elif algorithm == "hw":
        out = (best, Q - 1, bj)
    else:  # ov: ties go to the last-row end
        use_col = cap > best
        out = (torch.where(use_col, cap, best),
               torch.where(use_col, ci, Q - 1),
               torch.where(use_col, lens - 1, bj))
    if not (with_ends or score_planes):
        out = (out[0], torch.full_like(best, -1), torch.full_like(best, -1))
    return tuple(x.to(torch.int32) for x in out)


def wave_start(Q, go, ge, algorithm):
    """`track_start` of ``csrc/dp.cuh``: ``(5, N)`` trackers before the
    first column of queries of ``Q`` rows."""
    Q = Q.to(torch.int64)
    empty = -(int(go) + (Q - 1) * int(ge))
    neg1 = torch.full_like(Q, -1)
    best = empty if algorithm == "hw" else torch.zeros_like(Q)
    cap = empty if algorithm == "nw" else torch.full_like(Q, sweep.NEG)
    return torch.stack([best, cap, neg1, neg1, neg1])


def wave_reference(
    profs,
    qlens,
    flat_targets,
    lengths,
    bos,
    cos,
    los,
    go,
    ge,
    algorithm,
    with_ends,
    chunk=64,
    G=None,
    R=WAVE_R,
    pad_rows=False,
    score_planes=False,
    packed_cap=None,
):
    """K1 as its CUDA kernel computes it: `wave_walk_reference` for every
    (query, target lane), ``G`` threads of ``R`` rows each (``G``: the
    kernel's `wave_group` of the tier by default).  Same inputs and
    outputs as `search_flat` under ``safe_pad``; CPU tensors only.
    With ``pad_rows`` every walk covers all ``Q_pad`` rows, and with
    ``score_planes`` the score-mode end planes are K4's
    (`wave_v1_reference`, `wave_strip_reference`).  With ``packed_cap``
    (sw score mode) it is K1's packed route (``csrc/ragged_packed.cu``):
    the pair form of the packed walk over lanes ``2k``, ``2k + 1``, H
    capped at ``packed_cap``, the tracker packed and unpacked as the
    kernel holds it.  The tests hold it against the JAX package and K1's
    plain version; no call path uses it."""
    del cos, los
    n_q, q_pad, _ = profs.shape
    n_blocks, _, lanes = lengths.shape
    N = n_blocks * lanes
    G = wave_group(q_pad, R) if G is None else G
    lens = lengths.reshape(-1).to(torch.int64)
    tgt = sweep.columns_from_flat(flat_targets, lengths, bos, chunk)
    tgt = tgt.to(torch.int64).repeat(1, n_q)  # walk = query * N + lane
    T = tgt.shape[0]
    Q = torch.clamp(qlens.to(torch.int64), max=q_pad).repeat_interleave(N)
    lens = lens.repeat(n_q)
    walk_prof = torch.arange(n_q).repeat_interleave(N)
    buf = torch.zeros((T, n_q * N), dtype=torch.int64)
    rows = torch.full_like(Q, q_pad) if pad_rows else Q
    trk = wave_start(Q, go, ge, algorithm)
    pair = packed_cap is not None
    if pair:  # the tracker holds G: -go is the score 0
        trk[0] = -int(go)
    trk = wave_walk_reference(
        profs.reshape(-1), q_pad, walk_prof, 0, rows, Q, tgt, lens, buf, buf,
        buf.clone(), buf.clone(), go, ge, algorithm, with_ends, trk, G, R,
        False, pad_rows=pad_rows, narrow=pair,
        h_cap=packed_cap if pair else WAVE_CAP, pair=pair,
    )
    if pair:  # low half lane 2k, high half lane 2k + 1
        lo, hi = unpack_halves(trk[0, 0::2], trk[0, 1::2])
        trk[0] = torch.stack([lo, hi], 1).reshape(-1) + int(go)
    out = wave_finish(trk, Q, lens, algorithm, with_ends, score_planes)
    return tuple(x.reshape(n_q, n_blocks, lanes) for x in out)


def wave_v1_reference(profs, qlens, flat_targets, lengths, bos, cos, los,
                      go, ge, algorithm, with_ends, chunk=64, G=None,
                      R=WAVE_R, pad_rows=None):
    """K4 as its CUDA kernel computes it: K1's walk over rows ``[0, Q)``
    when both gaps are >= 0, else over every ``Q_pad`` row with the
    pad-row walk (``pad_rows`` forces either), and K4's score-mode end
    planes.  Same inputs and outputs as `search_flat` without
    ``safe_pad`` at K4's tiers; CPU tensors only.  The tests hold it
    against the JAX package; no call path uses it."""
    if pad_rows is None:
        pad_rows = go < 0 or ge < 0
    return wave_reference(
        profs, qlens, flat_targets, lengths, bos, cos, los, go, ge,
        algorithm, with_ends, chunk, G, R, pad_rows=pad_rows,
        score_planes=True)


def wave_strip_reference(profs, qlens, flat_targets, lengths, bos, cos, los,
                         go, ge, algorithm, chunk=64, G=None, R=WAVE_R):
    """K5 as its CUDA kernel computes it: score only, K1's walk over rows
    ``[0, Q)`` when both gaps are >= 0, else over every ``Q_pad`` row with
    the pad-row walk.  Same inputs and outputs as `search_flat` without
    ``safe_pad`` at K5's tiers; CPU tensors only.  The tests hold it
    against the plain version and the JAX package; no call path uses
    it."""
    return wave_reference(
        profs, qlens, flat_targets, lengths, bos, cos, los, go, ge,
        algorithm, False, chunk, G, R, pad_rows=go < 0 or ge < 0)
