"""Single-query-cohort kernel over the flat packed database (K1).

Port of ``pyopal_tpu/ops/pallas_ragged.py``: `search_flat` (l.1049)
with the `_ragged_kernel_v2` kernel (l.400) it launches under
``safe_pad``, `make_profiles_host` (l.155), `profile_qpad` (l.105) and
`supports` (l.80).  The kernel is hand-written CUDA C++ in
``csrc/ragged.cu``; its design (one thread per query x target lane,
columns outer, rows inner) is described there.

Three things live here:

- `search_flat`, the wrapper: it checks its inputs, launches the CUDA
  kernel for CUDA tensors and counts `launches`; for CPU tensors it runs
  the plain version instead.  A CUDA tensor never falls back.
- `search_flat_reference`, the plain PyTorch version of the same
  function (a column sweep, `pyopal_tpu_torch.ops.sweep`).
- the host-side profiles and tier helpers shared with the engine,
  including the fine tiers of single long queries (`fine_qpad`,
  `supports_fine`, ``pallas_ragged.py`` l.113-152), which K1 takes in
  one launch.

Output semantics (all four algorithms, score-only or with ends) follow
the reference kernel exactly, including the empty-target values; in
score-only mode both end planes are -1.
"""

from __future__ import annotations

import numpy as np
import torch

from . import sweep

ALPHA = 32  # profile columns (MAX_ALPHABET_SIZE)
#: profile entries of rows past a query's length and of pad column 31
#: (the reference's ``pallas_kernel.PAD_SCORE``, as an integer)
PAD_SCORE = -4_000_000
#: largest power-of-two query tier (`supports`; reference
#: ``RAGGED_MAX_QPAD_STRIP``); single long queries go beyond it at fine
#: tiers (`supports_fine`)
MAX_QPAD = 4096
LANES = 128

ALGO_CODES = {"sw": 0, "nw": 1, "hw": 2, "ov": 3}
#: largest H/E scratch (bytes) one kernel launch may use; a call that
#: needs more is split into launches over query and lane ranges
SCRATCH_BYTES = 2 << 30

#: plain-version runs made by the wrapper on CPU tensors
plain_calls = 0
#: kernel launches made by `search_flat` on CUDA tensors
launches = 0


def supports(Q: int) -> bool:
    """Whether the kernel takes a query of length ``Q`` (the reference
    `supports` under ``safe_pad``, so both packages route alike)."""
    return 0 < Q <= MAX_QPAD


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
    ``unit_rows`` query rows each, over ``n_lanes`` target lanes; one
    (unit, lane) needs ``unit_rows`` int2 scratch cells.  A launch takes
    every lane and as many units as fit, or one unit and a multiple of
    128 lanes when all lanes do not fit (at least 128 lanes whatever the
    budget).  Returns ``(units, lanes, chunks)``: the scratch extent of
    one launch and its ``(unit0, unit1, lane0, lane1)`` ranges.
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
):
    """Every query x the whole flat-packed database.

    One kernel launch, or several where one launch's H/E scratch would
    exceed `SCRATCH_BYTES` (`launch_plan`); each adds one to `launches`.

    Arguments:
        profs: ``(n_q, Q_pad, 32)`` int32 profiles (`make_profiles_host`)
            at a power-of-two tier or, for one long query, a fine tier.
        qlens: ``(n_q,)`` int32 query lengths.
        flat_targets: ``(total_rows, lanes)`` uint8 symbols.
        lengths: ``(n_blocks, 1, lanes)`` int32 target lengths.
        bos / cos / los: the layout's ``(n_steps,)`` int32 step maps.
        chunk: the layout's column-chunk quantum.

    Returns:
        ``(scores, q_ends, t_ends)``, int32 of shape
        ``(n_q, n_blocks, lanes)``.
    """
    global launches, plain_calls
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
    if dev.type == "cpu":
        plain_calls += 1
        return search_flat_reference(
            profs, qlens, flat_targets, lengths, bos, cos, los,
            go, ge, algorithm, with_ends, chunk,
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
    units, n_lanes, chunks = launch_plan(n_q, q_pad, n_blocks * lanes)
    scratch = torch.empty(
        (units, q_pad, n_lanes, 2), dtype=torch.int32, device=dev
    )
    for q0, q1, n0, n1 in chunks:  # one stream: launches reuse scratch
        _cuda.launch(
            "ragged",
            profs[q0:q1], qlens[q0:q1], flat_targets, lengths, row_off,
            *(o[q0:q1] for o in outs), scratch,
            q1 - q0, q_pad, n_blocks, lanes, n0, n1 - n0, int(go), int(ge),
            ALGO_CODES[algorithm], int(bool(with_ends)),
        )
        launches += 1
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
):
    """Plain PyTorch version of `search_flat` (same inputs, outputs)."""
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
