"""Query-grouped kernels over the flat packed database (K2, K7).

Port of ``pyopal_tpu/ops/pallas_q8.py``: `search_flat_q8` (l.467) with
the `_q8_kernel` kernel (l.138) and `make_profiles_q8_host` (l.109).
The kernel runs in two forms, each hand-written CUDA C++: the exact
int32 pass, ``narrow=False`` (K2, ``csrc/q8.cu``), and the packed sw
score-only walk (``csrc/q8_narrow.cu``).  The packed walk serves K7, the
saturating pass of ``narrow=True`` (l.180-202, 310-313), whose scores are
min(sw score, `NARROW_CAP`): a lane that reads `NARROW_CAP` is flagged
for an exact rescore, every other lane is exact.  It also serves K2's
exact route, ``packed_cap``: H's cap raised to a bound no cell of the
call reaches, so that the scores are K2's.
The interface is the reference's: groups of `QB` same-tier queries with
row-interleaved profiles, per-slot lengths ``qv`` and per-group row
bounds ``maxq``, over 256- or 512-lane packs, giving ``(n_groups,
n_blocks, QB, lanes)`` outputs, so the engine's `plan_tier_launches` and
q8 assembly are unchanged.  On the GPU the group of 8 has no hardware
meaning: K2 walks each (group, slot) as one query of K1's wavefront walk
(``csrc/wave.cuh``: a group of threads per (group, slot, target lane),
its rows in registers, the walk ending at the slot's own length); K7
and K2's exact route walk each pair of slots (2p, 2p + 1) as one walk
of the same kind in its packed 16-bit form, two queries in each register
(Hopper's s16x2 DPX instructions), to the pair's longer length.

As in `pyopal_tpu_torch.ops.ragged`: `search_flat_q8` launches the
kernel for CUDA tensors (counted in `launches` by kernel) and takes the
plain version `search_flat_q8_reference` (K2's, or with ``narrow``
K7's) for CPU tensors only (counted in `plain_calls`).
`wave_reference` and `narrow_wave_reference` are K2 and the packed
walk (K7, or K2's exact route with its cap) as their kernels compute
them, for the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import spanned
from . import sweep
from .ragged import (
    ALGO_CODES,
    ALPHA,
    PAD_SCORE,
    WAVE_CAP,
    WAVE_R,
    check_flat,
    packed_fits,
    profile_qpad,
    unpack_halves,
    wave_buffer,
    wave_finish,
    wave_group,
    wave_start,
    wave_walk_reference,
)

QB = 8  # queries per group
#: largest query tier the kernel takes (reference ``MAX_QPAD``)
MAX_QPAD = 1024
#: the narrow pass's clamp on H (reference ``NARROW_CAP``)
NARROW_CAP = WAVE_CAP

#: kernel launches made by `search_flat_q8` on CUDA tensors, by route
#: (K2's int32 walk, K7 with ``narrow``, K2's exact packed walk with
#: ``packed_cap``)
launches = {"q8": 0, "q8_narrow": 0, "q8_packed": 0}
#: plain-version runs made by the wrapper on CPU tensors, by kernel
plain_calls = dict.fromkeys(launches, 0)


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


@spanned("pyopal.launch")
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
    narrow=False,
    packed_cap=None,
):
    """All query groups x the whole flat-packed database.

    One kernel launch, or several where one launch's pass buffer (at
    tiers beyond one pass of the walk: 512 and 1024) would exceed
    `ragged.SCRATCH_BYTES` (`ragged.wave_buffer`); each adds one to
    ``launches["q8"]`` (K2), with ``narrow`` to ``launches["q8_narrow"]``
    (K7), with ``packed_cap`` to ``launches["q8_packed"]``.

    ``qv`` must be constant along lanes (as `make_profiles_q8_host`
    builds it): both versions read each slot's length at lane 0.
    ``maxq`` is checked for shape only; each slot's row loop ends at
    its own length.  Returns ``(scores, q_ends, t_ends)`` of shape
    ``(n_groups, n_blocks, QB, lanes)`` int32.

    ``narrow=True`` (sw score-only, gaps in ``[0, NARROW_CAP]``, else
    `ValueError` as in the reference) runs the saturating pass: scores
    are min(sw score, `NARROW_CAP`), both end planes -1.

    ``packed_cap`` (sw score-only, `ragged.packed_fits` of the gaps and
    the cap, else `ValueError`) runs K2 on the packed walk with H capped
    at ``packed_cap``: min(sw score, ``packed_cap``) in each slot, so
    K2's scores where the caller proves that no cell exceeds the cap
    (`engine._packed_exact_domain`); both end planes -1, as K2 writes
    them in score mode.  The plain version is K2's.
    """
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
    if narrow and not (
        algorithm == "sw"
        and not with_ends
        and 0 <= go <= NARROW_CAP
        and 0 <= ge <= NARROW_CAP
    ):
        raise ValueError(
            "narrow=True supports only sw score-only with gap "
            f"parameters in [0, {NARROW_CAP}]"
        )
    if packed_cap is not None and (
        narrow
        or algorithm != "sw"
        or with_ends
        or not packed_fits(int(go), int(ge), int(packed_cap))
    ):
        raise ValueError(
            "packed_cap supports only sw score-only with gaps and a cap "
            "that keep every intermediate in int16 (ragged.packed_fits)"
        )
    cap = NARROW_CAP if narrow else packed_cap
    name = "q8_narrow" if narrow else "q8" if cap is None else "q8_packed"
    if dev.type == "cpu":
        plain_calls[name] += 1
        return search_flat_q8_reference(
            profs, qv, maxq, flat_targets, lengths, bos, cos, los, go, ge,
            algorithm, with_ends, chunk, narrow,
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
    # the pass buffer, as K1's: per slot (K2) or per pair of slots (the
    # packed walk)
    chunks, pbuf = wave_buffer(n_g, QB if cap is None else QB // 2, q_pad,
                               flat_targets, n_blocks)
    for g0, g1, n0, n1 in chunks:  # one stream: launches reuse the buffer
        _cuda.launch(
            "q8" if cap is None else "q8_narrow",
            profs[g0:g1], qv[g0:g1], flat_targets, lengths, row_off,
            *(o[g0:g1] for o in outs), pbuf,
            g1 - g0, q_pad, n_blocks, lanes, n0, n1 - n0, int(go), int(ge),
            ALGO_CODES[algorithm], int(bool(with_ends)),
            flat_targets.shape[0], wave_group(q_pad),
            *(() if cap is None else (int(cap),)),
        )
        launches[name] += 1
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
    narrow=False,
    packed_cap=None,
):
    """Plain PyTorch version of `search_flat_q8` (same inputs, outputs).

    With ``narrow`` (K7's plain version): the sw score-only scores,
    clamped at `NARROW_CAP`, with -1 in both end planes.  ``packed_cap``
    changes nothing: K2's packed route returns K2's scores.
    """
    del maxq, cos, los, packed_cap
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
    if narrow:
        s = s.clamp(max=NARROW_CAP)
    if not with_ends:
        qe = torch.full_like(s, -1)
        te = torch.full_like(s, -1)
    return tuple(
        x.reshape(n_g, QB, n_blocks, lanes).permute(0, 2, 1, 3).contiguous()
        for x in (s, qe, te)
    )


def wave_reference(profs, qv, maxq, flat_targets, lengths, bos, cos, los,
                   go, ge, algorithm, with_ends, chunk=64, G=None, R=WAVE_R):
    """K2 as its CUDA kernel computes it: `ragged.wave_walk_reference` for
    every (group, slot, target lane), ``G`` threads of ``R`` rows each
    (``G``: the kernel's `ragged.wave_group` of the tier by default),
    reading slot ``s``'s row ``i`` at row ``QB * i + s`` of its group's
    profile.  Same inputs and outputs as `search_flat_q8`; CPU tensors
    only.  The tests hold it against the JAX package; no call path uses
    it."""
    del maxq, cos, los
    n_g = profs.shape[0]
    q_pad = profs.shape[1] // QB
    n_blocks, _, lanes = lengths.shape
    N = n_blocks * lanes
    G = wave_group(q_pad, R) if G is None else G
    lens = lengths.reshape(-1).to(torch.int64).repeat(n_g * QB)
    tgt = sweep.columns_from_flat(flat_targets, lengths, bos, chunk)
    tgt = tgt.to(torch.int64).repeat(1, n_g * QB)  # walk = slot * N + lane
    Q = torch.clamp(qv[:, :, 0].reshape(-1).to(torch.int64), max=q_pad)
    Q = Q.repeat_interleave(N)
    buf = torch.zeros(tgt.shape, dtype=torch.int64)
    trk = wave_walk_reference(
        profs.reshape(-1), q_pad, torch.arange(n_g * QB).repeat_interleave(N),
        0, Q, Q, tgt, lens, buf, buf, buf.clone(), buf.clone(), go, ge,
        algorithm, with_ends, wave_start(Q, go, ge, algorithm), G, R, False,
        interleave=QB,
    )
    out = wave_finish(trk, Q, lens, algorithm, with_ends, False)
    return tuple(
        x.reshape(n_g, QB, n_blocks, lanes).permute(0, 2, 1, 3).contiguous()
        for x in out)


def narrow_wave_reference(profs, qv, maxq, flat_targets, lengths, bos, cos,
                          los, go, ge, chunk=64, G=None, R=WAVE_R,
                          cap=NARROW_CAP):
    """The packed walk as its CUDA kernel computes it, with H capped at
    ``cap``: K7 at `NARROW_CAP`, K2's exact route (``packed_cap``) at a
    bound no cell reaches.  The packed walk of
    ``csrc/wave.cuh`` for every (group, pair of slots, target lane), run
    here as `ragged.wave_walk_reference` with ``narrow`` on each half
    (slot ``2p`` the low one, ``2p + 1`` the high one; s16x2 arithmetic
    never carries between halves, as no intermediate leaves int16, which
    the walk asserts).  Both halves walk rows ``[0, max(Q_2p, Q_2p+1))``:
    the shorter slot's rows past its length are its profile's pad rows,
    an empty slot's every row.  The trackers of G = min(H, cap) - go are
    packed into one int32 as the kernel holds them, then unpacked
    (sign-extended) with go added back.  ``G`` threads of ``R`` rows
    (``G``: the kernel's `ragged.wave_group` of the tier by default).
    Same inputs and outputs as `search_flat_q8` with ``narrow`` or
    ``packed_cap`` (sw, score only, gaps and cap within
    `ragged.packed_fits`); CPU tensors only.  The tests hold it against
    the JAX package and K2's plain version; no call path uses it."""
    del maxq, cos, los
    go, ge, cap = int(go), int(ge), int(cap)
    if not packed_fits(go, ge, cap):
        raise ValueError(f"gaps {go}, {ge} and cap {cap} leave int16")
    n_g = profs.shape[0]
    q_pad = profs.shape[1] // QB
    n_blocks, _, lanes = lengths.shape
    N = n_blocks * lanes
    G = wave_group(q_pad, R) if G is None else G
    lens = lengths.reshape(-1).to(torch.int64).repeat(n_g * QB)
    tgt = sweep.columns_from_flat(flat_targets, lengths, bos, chunk)
    tgt = tgt.to(torch.int64).repeat(1, n_g * QB)  # walk = slot * N + lane
    Q = torch.clamp(qv[:, :, 0].reshape(-1).to(torch.int64), max=q_pad)
    rows = Q.reshape(-1, 2).amax(1).repeat_interleave(2)  # the pair's
    rows = rows.repeat_interleave(N)
    buf = torch.zeros(tgt.shape, dtype=torch.int64)
    trk = wave_start(rows, go, ge, "sw")
    trk[0] = -go  # the tracker holds G: -go is the score 0
    trk = wave_walk_reference(
        profs.reshape(-1), q_pad, torch.arange(n_g * QB).repeat_interleave(N),
        0, rows, rows, tgt, lens, buf, buf, buf.clone(), buf.clone(), go, ge,
        "sw", False, trk, G, R, False, interleave=QB, narrow=True, h_cap=cap,
    )
    half = trk[0].reshape(n_g * QB // 2, 2, N)
    lo, hi = unpack_halves(half[:, 0], half[:, 1])
    score = torch.stack([lo, hi], 1).reshape(n_g, QB, n_blocks, lanes) + go
    score = score.permute(0, 2, 1, 3).contiguous().to(torch.int32)
    return score, torch.full_like(score, -1), torch.full_like(score, -1)
