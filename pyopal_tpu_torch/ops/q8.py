"""Query-grouped kernel over the flat packed database (K2).

Port of ``pyopal_tpu/ops/pallas_q8.py``: `search_flat_q8` (l.467) with
the `_q8_kernel` kernel (l.138, ``narrow=False``) and
`make_profiles_q8_host` (l.109).  The kernel is hand-written CUDA C++ in
``csrc/q8.cu``.  The interface is the reference's: groups of `QB`
same-tier queries with row-interleaved profiles, per-slot lengths
``qv`` and per-group row bounds ``maxq``, over 256- or 512-lane packs,
giving ``(n_groups, n_blocks, QB, lanes)`` outputs, so the engine's
`plan_tier_launches` and q8 assembly are unchanged.  On the GPU the
group of 8 has no hardware meaning: each (group, slot, lane) is one
thread whose row loop ends at its own query length.

As in `pyopal_tpu_torch.ops.ragged`: `search_flat_q8` launches the
kernel for CUDA tensors (counting `launches`) and takes the plain
version `search_flat_q8_reference` for CPU tensors only.
"""

from __future__ import annotations

import numpy as np
import torch

from . import sweep
from .ragged import (
    ALGO_CODES,
    ALPHA,
    PAD_SCORE,
    check_flat,
    launch_plan,
    profile_qpad,
)

QB = 8  # queries per group
#: largest query tier the kernel takes (reference ``MAX_QPAD``)
MAX_QPAD = 1024

#: plain-version runs made by the wrapper on CPU tensors
plain_calls = 0
#: kernel launches made by `search_flat_q8` on CUDA tensors
launches = 0


def plan_groups(qlens) -> list:
    """Order query indices into groups of `QB` by descending length."""
    order = sorted(range(len(qlens)), key=lambda i: -int(qlens[i]))
    return [order[k : k + QB] for k in range(0, len(order), QB)]


def make_profiles_q8_host(queries_enc, matrix, groups, lanes=128) -> tuple:
    """Interleaved profile stack + per-slot lengths for `search_flat_q8`.

    Returns ``(profs, qv, maxq)``:

    - ``profs``: ``(n_groups, QB * Q_pad, 32)`` int32, row ``8*i + qb``
      = profile row ``i`` of the group's ``qb``-th query; empty slots
      and rows past a query's true length hold ``PAD_SCORE``.
    - ``qv``: ``(n_groups, QB, lanes)`` int32 true lengths (0 = empty
      slot), broadcast along lanes.
    - ``maxq``: ``(n_groups,)`` int32 longest query of each group.
    """
    qmax = max((len(queries_enc[i]) for g in groups for i in g), default=8)
    Q_pad = profile_qpad(max(qmax, 8))
    S = np.asarray(matrix, dtype=np.int32)
    n_g = len(groups)
    profs = np.full((n_g, QB * Q_pad, ALPHA), PAD_SCORE, dtype=np.int32)
    qv = np.zeros((n_g, QB, lanes), dtype=np.int32)
    maxq = np.zeros((n_g,), dtype=np.int32)
    for g, idxs in enumerate(groups):
        for qb, qi in enumerate(idxs):
            q = np.asarray(queries_enc[qi], dtype=np.int64)
            Q = q.shape[0]
            profs[g, qb : QB * Q : QB, : S.shape[1]] = S[q, :]
            qv[g, qb, :] = Q
            maxq[g] = max(maxq[g], Q)
    return profs, qv, maxq


def search_flat_q8(
    profs,
    qv,
    maxq,
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
    """All query groups x the whole flat-packed database.

    One kernel launch, or several where one launch's H/E scratch would
    exceed `ragged.SCRATCH_BYTES` (`ragged.launch_plan`); each adds one
    to `launches`.

    ``qv`` must be constant along lanes (as `make_profiles_q8_host`
    builds it): both versions read each slot's length at lane 0.
    ``maxq`` is checked for shape only; each slot's row loop ends at
    its own length.  Returns ``(scores, q_ends, t_ends)`` of shape
    ``(n_groups, n_blocks, QB, lanes)`` int32.
    """
    global launches, plain_calls
    dev = profs.device
    check_flat(flat_targets, lengths, bos, cos, los, dev)
    for name, t in (("profs", profs), ("qv", qv), ("maxq", maxq)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if profs.ndim != 3 or profs.shape[2] != ALPHA or profs.shape[1] % QB:
        raise ValueError(f"profs must be (n_groups, {QB} * Q_pad, {ALPHA})")
    n_g = profs.shape[0]
    q_pad = profs.shape[1] // QB
    if q_pad > MAX_QPAD:
        raise ValueError(f"query tier {q_pad} exceeds {MAX_QPAD}")
    lanes = flat_targets.shape[1]
    if qv.shape != (n_g, QB, lanes) or maxq.shape != (n_g,):
        raise ValueError("qv must be (n_groups, 8, lanes), maxq (n_groups,)")
    if algorithm not in ALGO_CODES:
        raise ValueError(f"invalid algorithm: {algorithm!r}")
    if dev.type == "cpu":
        plain_calls += 1
        return search_flat_q8_reference(
            profs, qv, maxq, flat_targets, lengths, bos, cos, los,
            go, ge, algorithm, with_ends, chunk,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")

    from . import _cuda

    n_blocks = lengths.shape[0]
    row_off = sweep.block_row_offsets(bos, n_blocks, chunk)
    outs = [
        torch.empty((n_g, n_blocks, QB, lanes), dtype=torch.int32, device=dev)
        for _ in range(3)
    ]
    units, n_lanes, chunks = launch_plan(n_g, QB * q_pad, n_blocks * lanes)
    scratch = torch.empty(
        (units, QB * q_pad, n_lanes, 2), dtype=torch.int32, device=dev
    )
    for g0, g1, n0, n1 in chunks:  # one stream: launches reuse scratch
        _cuda.launch(
            "q8",
            profs[g0:g1], qv[g0:g1], flat_targets, lengths, row_off,
            *(o[g0:g1] for o in outs), scratch,
            g1 - g0, q_pad, n_blocks, lanes, n0, n1 - n0, int(go), int(ge),
            ALGO_CODES[algorithm], int(bool(with_ends)),
        )
        launches += 1
    return tuple(outs)


def search_flat_q8_reference(
    profs,
    qv,
    maxq,
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
    """Plain PyTorch version of `search_flat_q8` (same inputs, outputs)."""
    del maxq, cos, los
    n_g = profs.shape[0]
    q_pad = profs.shape[1] // QB
    n_blocks, _, lanes = lengths.shape
    # de-interleave: slot qb of group g becomes query g * QB + qb
    per_slot = (
        profs.reshape(n_g, q_pad, QB, ALPHA)
        .permute(0, 2, 1, 3)
        .reshape(n_g * QB, q_pad, ALPHA)
    )
    targets = sweep.columns_from_flat(flat_targets, lengths, bos, chunk)
    s, qe, te = sweep.sweep_batch(
        per_slot,
        qv[:, :, 0].reshape(-1),
        targets,
        lengths.reshape(-1),
        go,
        ge,
        algorithm,
    )
    if not with_ends:
        qe = torch.full_like(s, -1)
        te = torch.full_like(s, -1)
    return tuple(
        x.reshape(n_g, QB, n_blocks, lanes).permute(0, 2, 1, 3).contiguous()
        for x in (s, qe, te)
    )
