"""One query over a stacked group of target blocks (K6).

Port of ``pyopal_tpu/ops/pallas_kernel.py``: `search_group` (l.366) with
the `_dp_kernel` kernel (l.119) it launches, `supports` (l.64) and the
profiles `make_profile` / `make_profile_host` (l.73-91).  The group comes
from the grouped layout (`pyopal_tpu_torch.ops.packing.pack_sequences`):
``(n_blocks, t_pad, lanes)`` targets, one per lane, with ``(n_blocks,
lanes)`` lengths.  The kernel is hand-written CUDA C++ in
``csrc/group.cu``; its design is described there.  Its path is the
sharded group search (`pyopal_tpu_torch.parallel.sharded`).

As in `pyopal_tpu_torch.ops.ragged`:

- `search_group`, the wrapper: it checks its inputs, launches the kernel
  for CUDA tensors and counts `launches` (several where the H/E scratch
  would exceed ``ragged.SCRATCH_BYTES``); for CPU tensors it runs the
  plain version and counts `plain_calls`.  A CUDA tensor never falls
  back.
- `search_group_reference`, the plain PyTorch version: a column sweep
  over every profile row with ``torch.cummax`` for the vertical gap.

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

from ..models import ALGORITHMS
from . import sweep
from .ragged import ALGO_CODES, ALPHA, PAD_SCORE, launch_plan

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

    One kernel launch, or several over lane ranges where one launch's H/E
    scratch would exceed ``ragged.SCRATCH_BYTES``; each adds one to
    `launches`.

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
    outs = [
        torch.empty((n_blocks, lanes), dtype=torch.int32, device=dev)
        for _ in range(3)
    ]
    _, n_lanes, chunks = launch_plan(1, q_pad, n_blocks * lanes)
    scratch = torch.empty((q_pad, n_lanes, 2), dtype=torch.int32, device=dev)
    for _, _, n0, n1 in chunks:  # one stream: launches reuse scratch
        _cuda.launch(
            "group",
            prof, targets, lengths, *outs, scratch,
            Q, q_pad, t_pad, n_blocks, lanes, n0, n1 - n0, int(go), int(ge),
            ALGO_CODES[algorithm], int(bool(with_ends)),
        )
        launches += 1
    return tuple(outs)


def search_group_reference(
    prof_and_q, targets, lengths, go, ge, algorithm, with_ends=True
):
    """Plain PyTorch version of `search_group` (same inputs, outputs).

    A column sweep over all ``Q_pad`` profile rows, vectorized over rows
    and the lanes still inside their target (lanes visited in length
    order).  The vertical gap follows the identity of `ops.sweep`, with
    the closed-form row above the query as the prefix max's first term.
    """
    prof, Q = prof_and_q
    Q = int(Q)
    spec = ALGORITHMS[algorithm]
    dev = prof.device
    i32 = torch.int32
    go, ge = int(go), int(ge)
    gmin = min(go, ge)
    R = prof.shape[0]
    n_blocks, t_pad, lanes = targets.shape
    N = n_blocks * lanes

    lens_h = lengths.reshape(-1).cpu().numpy().astype(np.int64)
    order = np.argsort(lens_h, kind="stable")
    sorted_lens = lens_h[order]
    t_max = int(sorted_lens[-1]) if N else 0
    first_active = np.searchsorted(sorted_lens, np.arange(t_max), "right")
    perm = torch.as_tensor(order, device=dev)
    lens = torch.as_tensor(sorted_lens, device=dev).to(i32)
    # column j of lane n (block n // lanes, lane n % lanes) at tgt[j, n]
    tgt = targets.permute(1, 0, 2).reshape(t_pad, N)[:t_max, perm].long()

    r = torch.arange(R + 1, device=dev, dtype=i32)[:, None]
    rows = r[:-1]
    if spec.penalize_first_col:
        H = -(go + rows * ge)
        empty = -(go + (Q - 1) * ge)
    else:
        H = torch.zeros_like(rows)
        empty = 0
    H = H.to(i32).expand(R, N).clone()
    E = torch.full((R, N), NEG, dtype=i32, device=dev)

    def full(v):
        return torch.full((N,), v, dtype=i32, device=dev)

    best = full(empty if algorithm == "hw" else 0)
    cap = full(empty if algorithm == "nw" else NEG)
    bi, bj, ci = full(-1), full(-1), full(-1)

    for j in range(t_max):
        k = int(first_active[j])
        if spec.penalize_first_row:
            row0_prev = 0 if j == 0 else -(go + (j - 1) * ge)
            row0_cur = -(go + j * ge)
        else:
            row0_prev = row0_cur = 0
        Hs = H[:, k:]
        E_new = torch.maximum(Hs - go, E[:, k:] - ge)
        above = torch.cat([torch.full_like(Hs[:1], row0_prev), Hs[:-1]])
        tmp = torch.maximum(above + prof.index_select(1, tgt[j, k:]), E_new)
        if spec.clamp_zero:
            tmp.clamp_(min=0)
        # F[i] = max(row0 - go - i*gmin, max_{m < i} tmp[m] - go
        #            - (i-1-m)*gmin)
        tmp_full = torch.cat([torch.full_like(tmp[:1], row0_cur), tmp])
        cmax = torch.cummax(tmp_full + r * gmin, dim=0).values
        F = cmax[:-1] - go - rows * gmin
        H_new = torch.maximum(tmp, F)
        H[:, k:] = H_new
        E[:, k:] = E_new

        at_end = lens[k:] == j + 1
        if spec.track_all_cells or spec.track_last_col:
            colmax = H_new.max(dim=0).values
            coli = torch.where(H_new == colmax, rows, R).amin(0).to(i32)
        if spec.track_all_cells:  # sw
            upd = colmax > best[k:]
            best[k:] = torch.where(upd, colmax, best[k:])
            if with_ends:
                bi[k:] = torch.where(upd, coli, bi[k:])
                bj[k:] = torch.where(upd, j, bj[k:])
        if spec.track_last_row:  # hw / ov
            upd = H_new[Q - 1] > best[k:]
            best[k:] = torch.where(upd, H_new[Q - 1], best[k:])
            if with_ends:
                bj[k:] = torch.where(upd, j, bj[k:])
        if spec.track_terminal:  # nw
            cap[k:] = torch.where(at_end, H_new[Q - 1], cap[k:])
        if spec.track_last_col:  # ov
            cap[k:] = torch.where(at_end, colmax, cap[k:])
            if with_ends:
                ci[k:] = torch.where(at_end, coli, ci[k:])

    qlast = full(Q - 1)
    tlast = lens - 1
    if algorithm == "sw":
        hit = best > 0
        out = (best, torch.where(hit, bi, -1), torch.where(hit, bj, -1))
    elif algorithm == "nw":
        out = (cap, qlast, tlast)
    elif algorithm == "hw":
        out = (best, qlast, bj)
    else:  # ov: ties go to the last-row end
        use_col = cap > best
        out = (
            torch.maximum(best, cap),
            torch.where(use_col, ci, qlast),
            torch.where(use_col, tlast, bj),
        )
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(N, device=dev)
    return tuple(x.to(i32)[inv].reshape(n_blocks, lanes) for x in out)
