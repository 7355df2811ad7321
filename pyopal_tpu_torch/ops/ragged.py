"""Query-cohort kernels over the flat packed database (K1, K4, K5).

Port of ``pyopal_tpu/ops/pallas_ragged.py``: `search_flat` (l.1049)
with the three kernels it launches, `make_profiles_host` (l.155),
`profile_qpad` (l.105) and `supports` (l.80).  `search_flat` routes as
the reference does (l.1091-1107):

- ``safe_pad`` (the matrix leaves profile column 31, the pad symbol,
  unused: every bundled matrix): K1, `_ragged_kernel_v2` (l.400), every
  algorithm and mode (``csrc/ragged.cu``);
- otherwise score-only at query tiers of `STRIP_MIN_QPAD` rows and more:
  K5, `_ragged_kernel_strip` (l.732), score planes only
  (``csrc/ragged_strip.cu``);
- otherwise tiers up to `RAGGED_MAX_QPAD`: K4, `_ragged_kernel` (l.169),
  both modes (``csrc/ragged_v1.cu``);
- anything else raises `ValueError`, as the reference does.

K4 and K5 walk all ``Q_pad`` profile rows, pad rows included, and K4
fills the score-mode end planes from untracked positions, as their TPU
kernels do (`sweep.sweep_all_rows`); K1 stops at the query's length and
writes -1 planes in score mode.  Each kernel is hand-written CUDA C++;
its design (one thread per query x target lane, columns outer, rows
inner) is described in its source.

Three things live here:

- `search_flat`, the wrapper: it checks its inputs, launches the routed
  CUDA kernel for CUDA tensors and counts it in `launches`; for CPU
  tensors it runs the kernel's plain version instead and counts it in
  `plain_calls` (both keyed by kernel).  A CUDA tensor never falls back.
- `search_flat_reference`, the plain PyTorch version of the same
  function, routed alike: a column sweep (`pyopal_tpu_torch.ops.sweep`)
  for K1, `search_flat_v1_reference` for K4 and
  `search_flat_strip_reference` for K5.
- the host-side profiles and tier helpers shared with the engine,
  including the fine tiers of single long queries (`fine_qpad`,
  `supports_fine`, ``pallas_ragged.py`` l.113-152), which K1 takes in
  one launch.

Output semantics (all four algorithms, score-only or with ends) follow
the reference kernels exactly, including the empty-target values.
"""

from __future__ import annotations

import numpy as np
import torch

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
#: K5's strip height (reference ``STRIP``; ``csrc/ragged_strip.cu``)
STRIP = 256
#: smallest query tier that K5 takes (reference ``STRIP_MIN_QPAD``)
STRIP_MIN_QPAD = 512
LANES = 128

ALGO_CODES = {"sw": 0, "nw": 1, "hw": 2, "ov": 3}
#: largest H/E scratch (bytes) one kernel launch may use; a call that
#: needs more is split into launches over query and lane ranges
SCRATCH_BYTES = 2 << 30

#: kernel launches made by `search_flat` on CUDA tensors, by kernel
#: (`flat_route`'s names: K1, K4, K5)
launches = {"ragged": 0, "ragged_v1": 0, "ragged_strip": 0}
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


def launch_plan(n_units, unit_rows, n_lanes, budget=None, cell_bytes=8):
    """Split a kernel call into launches whose scratch fits ``budget``.

    A call covers ``n_units`` scratch units (queries, or q8 groups) of
    ``unit_rows`` query rows each, over ``n_lanes`` target lanes; one
    (unit, lane) needs ``unit_rows`` scratch cells of ``cell_bytes``
    (int2 H/E: 8; K7's short2: 4).  A launch takes every lane and as many
    units as fit, or one unit and a multiple of 128 lanes when all lanes
    do not fit (at least 128 lanes whatever the budget).  Returns
    ``(units, lanes, chunks)``: the scratch extent of one launch and its
    ``(unit0, unit1, lane0, lane1)`` ranges.
    """
    budget = SCRATCH_BYTES if budget is None else budget
    if n_units == 0 or n_lanes == 0:
        return 0, 0, []
    cap = max(budget // (cell_bytes * unit_rows), 128)  # (unit, lane) pairs
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
):
    """Every query x the whole flat-packed database.

    Runs the kernel `flat_route` names: K1 under ``safe_pad``, else K5
    for score-only calls at tiers of `STRIP_MIN_QPAD` rows and more, else
    K4.  One kernel launch, or several where one launch's scratch would
    exceed `SCRATCH_BYTES` (`launch_plan`); each adds one to the kernel's
    count in `launches`.

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
    if route != "ragged" and n_q:
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
    # K5's unit per (query, lane) is STRIP scratch rows and the H/F
    # boundary of the lane's columns (total_rows / n_blocks on average)
    strip = route == "ragged_strip"
    rows = flat_targets.shape[0]
    scr_rows = STRIP if strip else q_pad
    unit_rows = scr_rows + (-(-rows // max(n_blocks, 1)) if strip else 0)
    units, n_lanes, chunks = launch_plan(n_q, unit_rows, n_blocks * lanes)
    scratch = torch.empty(
        (units, scr_rows, n_lanes, 2), dtype=torch.int32, device=dev
    )
    extra = (
        torch.empty((units, 2, rows, lanes), dtype=torch.int32, device=dev),
        rows,
    ) if strip else ()
    for q0, q1, n0, n1 in chunks:  # one stream: launches reuse scratch
        _cuda.launch(
            route,
            profs[q0:q1], qlens[q0:q1], flat_targets, lengths, row_off,
            *(o[q0:q1] for o in outs), scratch,
            q1 - q0, q_pad, n_blocks, lanes, n0, n1 - n0, int(go), int(ge),
            ALGO_CODES[algorithm], int(bool(with_ends)), *extra,
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
    `search_flat_strip_reference` for K5, a column sweep for K1)."""
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
