"""One query over a stacked group of target blocks (K6).

Port of ``pyopal_tpu/ops/pallas_kernel.py``: `search_group` (l.366) with
the `_dp_kernel` kernel (l.119) it launches, `supports` (l.64) and the
profiles `make_profile` / `make_profile_host` (l.73-91).  The group comes
from the grouped layout (`pyopal_tpu_torch.ops.packing.pack_sequences`):
``(n_blocks, t_pad, lanes)`` targets, one per lane, with ``(n_blocks,
lanes)`` lengths.  The kernel is hand-written CUDA C++ in
``csrc/group.cu``: K4's wavefront walk (``csrc/wave.cuh``), a group of
`ragged.wave_group` threads per lane with 16 query rows each in
registers; its design is described there.  Its path is the sharded group
search (`pyopal_tpu_torch.parallel.sharded`).

As in `pyopal_tpu_torch.ops.ragged`:

- `search_group`, the wrapper: it checks its inputs, launches the kernel
  for CUDA tensors and counts `launches` (several where the pass buffer
  of a query beyond one pass of the walk would exceed
  ``ragged.SCRATCH_BYTES``); for CPU tensors it runs the plain version
  and counts `plain_calls`.  A CUDA tensor never falls back.
- `search_group_reference`, the plain PyTorch version: a column sweep
  over every profile row with ``torch.cummax`` for the vertical gap
  (`sweep.sweep_all_rows`, shared with K4 and K5).
- `wave_group_reference`, the kernel as it computes it on the CPU (the
  walk's emulation, `ragged.wave_walk_reference`): for the tests, which
  hold it against the JAX package; no call path runs it.

Outputs follow the reference kernel on every lane, padding lanes
included: it walks all ``Q_pad`` profile rows (rows past the query score
`PAD_SCORE`), reads hw/ov/nw's last row at ``Q - 1``, and in score mode
fills the end planes its finalize writes from untracked positions (nw
``Q - 1`` and ``len - 1``, hw ``Q - 1`` and -1, ov ``Q - 1`` and -1 or
-1 and ``len - 1``, sw -1 and -1).  The reference keeps the DP in f32,
exact below 2**24; the port keeps it in int32.
"""

from __future__ import annotations

import numpy as np
import torch

from . import sweep
from .ragged import (
    ALGO_CODES, ALPHA, PAD_SCORE, WAVE_R, launch_plan, wave_finish,
    wave_group, wave_start, wave_walk_reference,
)

#: longest query the kernel takes (reference ``MAX_QPAD``)
MAX_QPAD = 4096
NEG = sweep.NEG

#: plain-version runs made by the wrapper on CPU tensors
plain_calls = 0
#: kernel launches made by `search_group` on CUDA tensors
launches = 0


def supports(Q: int) -> bool:
    """Whether the kernel takes a query of length ``Q``."""
    return 0 < Q <= MAX_QPAD


def make_profile_host(query_enc: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """The ``(Q_pad, 32)`` int32 query profile, ``Q_pad = round_up(max(Q,
    8), 8)``; rows past the query and columns past the matrix hold
    `PAD_SCORE`."""
    q = np.asarray(query_enc, dtype=np.int64)
    S = np.asarray(matrix, dtype=np.int32)
    Q = q.shape[0]
    q_pad = -(-max(Q, 8) // 8) * 8
    prof = np.full((q_pad, ALPHA), PAD_SCORE, dtype=np.int32)
    prof[:Q, : S.shape[1]] = S[q, :]
    return prof


def make_profile(query_enc: np.ndarray, matrix: np.ndarray, device="cuda"):
    """``(profile, Q)``: `make_profile_host` on ``device`` and the query
    length, the first argument of `search_group`."""
    prof = torch.from_numpy(make_profile_host(query_enc, matrix))
    return prof.to(device), int(np.asarray(query_enc).shape[0])


def _check(prof, Q, targets, lengths, algorithm):
    dev = prof.device
    for name, t, dtypes in (
        ("prof", prof, (torch.int32,)),
        ("targets", targets, (torch.uint8, torch.int32)),
        ("lengths", lengths, (torch.int32,)),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if prof.ndim != 2 or prof.shape[1] != ALPHA:
        raise ValueError(f"prof must be (Q_pad, {ALPHA})")
    if not 0 < Q <= prof.shape[0]:
        raise ValueError(f"query length {Q} outside a {prof.shape[0]}-row "
                         "profile")
    if targets.ndim != 3 or lengths.shape != (targets.shape[0],
                                              targets.shape[2]):
        raise ValueError("expected targets (n_blocks, t_pad, lanes) and "
                         "lengths (n_blocks, lanes)")
    if algorithm not in ALGO_CODES:
        raise ValueError(f"invalid algorithm: {algorithm!r}")


def search_group(
    prof_and_q, targets, lengths, go, ge, algorithm, with_ends=True
):
    """One query x every lane of a stacked group of blocks.

    One kernel launch, or, for a query beyond one pass of the walk (256
    rows), several over lane ranges where one launch's pass buffer would
    exceed ``ragged.SCRATCH_BYTES``; each adds one to `launches`.

    Arguments:
        prof_and_q: ``(profile, Q)`` from `make_profile`: the
            ``(Q_pad, 32)`` int32 profile and the query length.
        targets: ``(n_blocks, t_pad, lanes)`` uint8 or int32 symbols
            (below 32), on the profile's device.
        lengths: ``(n_blocks, lanes)`` int32 target lengths, each at
            most ``t_pad``.

    Returns:
        ``(scores, q_ends, t_ends)``, int32 of shape ``(n_blocks, lanes)``.
    """
    global launches, plain_calls
    prof, Q = prof_and_q
    Q = int(Q)
    _check(prof, Q, targets, lengths, algorithm)
    dev = prof.device
    if dev.type == "cpu":
        plain_calls += 1
        return search_group_reference(
            (prof, Q), targets, lengths, go, ge, algorithm, with_ends
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")

    from . import _cuda

    n_blocks, t_pad, lanes = targets.shape
    targets = targets.to(torch.uint8)
    q_pad = prof.shape[0]
    G = wave_group(q_pad)
    outs = [
        torch.empty((n_blocks, lanes), dtype=torch.int32, device=dev)
        for _ in range(3)
    ]
    chunks, buf = [(0, n_blocks * lanes)], 0  # one pass: no buffer
    if q_pad > G * WAVE_R:
        # H and F of a pass's last row at each column of each lane,
        # [block][H, F][t_pad][lanes] from a launch's first block
        chunks = [c[2:] for c in launch_plan(1, t_pad, n_blocks * lanes)[2]]
        span = max((n1 - 1) // lanes - n0 // lanes + 1 for n0, n1 in chunks)
        buf = torch.empty((span, 2, t_pad, lanes), dtype=torch.int32,
                          device=dev)
    for n0, n1 in chunks:  # one stream: launches reuse the buffer
        _cuda.launch(
            "group",
            prof, targets, lengths, *outs, buf,
            Q, q_pad, t_pad, n_blocks, lanes, n0, n1 - n0, int(go), int(ge),
            ALGO_CODES[algorithm], int(bool(with_ends)), G,
        )
        launches += 1
    return tuple(outs)


def search_group_reference(
    prof_and_q, targets, lengths, go, ge, algorithm, with_ends=True
):
    """Plain PyTorch version of `search_group` (same inputs, outputs):
    `sweep.sweep_all_rows`, the column sweep over all ``Q_pad`` profile
    rows, over the group's lanes."""
    prof, Q = prof_and_q
    n_blocks, t_pad, lanes = targets.shape
    # column j of lane n (block n // lanes, lane n % lanes) at cols[j, n]
    cols = targets.permute(1, 0, 2).reshape(t_pad, n_blocks * lanes)
    out = sweep.sweep_all_rows(
        prof[None], [int(Q)], cols, lengths.reshape(-1), go, ge, algorithm,
        with_ends,
    )
    return tuple(x[0].reshape(n_blocks, lanes) for x in out)


def wave_group_reference(prof_and_q, targets, lengths, go, ge, algorithm,
                         with_ends=True, G=None, R=WAVE_R):
    """K6 as its CUDA kernel computes it: `ragged.wave_walk_reference`
    over the group's lanes, ``G`` threads of ``R`` rows each (``G``: the
    kernel's `ragged.wave_group` of ``Q_pad`` by default), rows ``[0,
    Q)`` when both gaps are >= 0, else every ``Q_pad`` row with the
    pad-row walk, and the score-mode end planes of `search_group`.  Same
    inputs and outputs as `search_group`; CPU tensors only.  The tests
    hold it against the JAX package; no call path uses it."""
    prof, Q = prof_and_q
    q_pad = prof.shape[0]
    n_blocks, t_pad, lanes = targets.shape
    N = n_blocks * lanes
    G = wave_group(q_pad, R) if G is None else G
    pad_rows = go < 0 or ge < 0
    i64 = torch.int64
    tgt = targets.permute(1, 0, 2).reshape(t_pad, N).to(i64)
    lens = lengths.reshape(-1).to(i64)
    Qv = torch.full((N,), int(Q), dtype=i64)
    rows = torch.full_like(Qv, q_pad if pad_rows else int(Q))
    buf = torch.zeros((t_pad, N), dtype=i64)
    trk = wave_walk_reference(
        prof.reshape(-1), q_pad, torch.zeros(N, dtype=i64), 0, rows, Qv, tgt,
        lens, buf, buf, buf.clone(), buf.clone(), go, ge, algorithm,
        with_ends, wave_start(Qv, go, ge, algorithm), G, R, False,
        pad_rows=pad_rows,
    )
    out = wave_finish(trk, Qv, lens, algorithm, with_ends, True)
    return tuple(x.reshape(n_blocks, lanes) for x in out)
