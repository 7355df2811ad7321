"""Full-alignment reconstruction (``mode="full"``): kernels T1 and T2.

Port of ``pyopal_tpu/ops/traceback.py``.  Two-phase, like the
reference: the score+end pass (K1/K2) runs over all targets, then each
requested alignment is reconstructed in padded batches of pairs:

- `_dir_matrix_batch` recomputes the DP of a batch and emits one packed
  ``uint8`` per cell: the source of ``H`` in bits 0-1 (diagonal, gap in
  the query, gap in the target, local stop; ties in that order) and the
  gap-open bits of ``E`` and ``F`` (bits 2 and 3; a tie opens).  On
  CUDA tensors it launches T1 (``csrc/traceback_dirs.cu``), which
  replaces the reference's jitted column scan (l.53): a group of
  `dirs_group` threads a pair, `DIRS_R` query rows a thread, along
  anti-diagonals, writing ``(B, T_pad, Qs)`` bytes (a column's rows
  contiguous) that the wrapper presents as the ``(B, Q, T_pad)`` view.
  Its plain version `dir_matrix_reference` is that scan on tensors, with
  an exact integer profile gather (the reference's one-hot f32 lookup and
  its ``int_lookup`` switch, l.89-97, are a TPU choice that gives the
  same bytes).
- `_walk_batch_device` follows the directions from each pair's end cell
  and emits one op per step, end to start, into a ``(steps, B)`` buffer
  (255 = none).  On CUDA tensors it launches T2
  (``csrc/traceback_walk.cu``), which replaces the reference's
  ``while_loop`` (l.197): a warp a pair walking `WALK_TILE` tiles of the
  direction bytes in shared memory, its ops contiguous per pair
  (``(B, LMAX_s)``, presented as the ``(LMAX, B)`` view).  Its plain
  version `walk_reference` is that loop on tensors.

As in `pyopal_tpu_torch.ops.ragged`, a wrapper launches its kernel for
CUDA tensors (counted in `launches`) and takes the plain version for CPU
tensors only (counted in `plain_calls`); a CUDA tensor never falls back.

`full_alignments_batch` keeps the reference's batching exactly (pairs
sorted by length, the `_alloc` accounting on the padded shape, the
scalar `naive.traceback` for oversized and degenerate pairs), so the
same pairs take the same path in both packages.  `_walk` is the host
walk, copied as it is (no call path runs it; the tests pin it to T2's
plain version).  Cross-validated against `naive.traceback`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import ALGORITHMS
from ..results import OP_DEL, OP_INS, OP_MATCH, OP_MISMATCH
from . import naive
from .ragged import ALGO_CODES

NEG = np.int32(-(2**30))

# direction codes (bits 0-1): source of H[i][j]
DIR_DIAG = 0
DIR_E = 1  # gap in query: from the left
DIR_F = 2  # gap in target: from above
DIR_STOP = 3  # sw: clamped zero — local alignment starts here
E_OPEN = 4  # bit 2: E came from H (gap open) rather than E (extend)
F_OPEN = 8  # bit 3: F came from H (gap open)

#: pairs with more DP cells than this go to the scalar fallback
MAX_DEVICE_CELLS = 64 * 1024 * 1024

#: T1's query rows per thread, and its threads per pair at most (one
#: pass covers ``DIRS_R * DIRS_MAX_G`` = 256 rows)
DIRS_R = 8
DIRS_MAX_G = 32
#: T2's tile of direction bytes in shared memory: (rows, columns)
WALK_TILE = (64, 64)

#: kernel launches made by the wrappers on CUDA tensors, by kernel (T1
#: `_dir_matrix_batch`, T2 `_walk_batch_device`)
launches = {"traceback_dirs": 0, "traceback_walk": 0}
#: plain-version runs made by the wrappers on CPU tensors, by kernel
plain_calls = dict.fromkeys(launches, 0)


def _round_up_128(n: int) -> int:
    return ((n + 127) // 128) * 128


def _round_up_16(n: int) -> int:
    return ((n + 15) // 16) * 16


def dirs_group(Q: int, R: int = DIRS_R, max_g: int = DIRS_MAX_G) -> int:
    """T1's threads per pair for a query of ``Q`` rows: the least power
    of two, at least 2, whose ``G * R`` rows cover ``min(Q, max_g * R)``;
    longer queries take passes of ``max_g * R`` rows."""
    g = 2
    while g < max_g and g * R < Q:
        g *= 2
    return g


def _i32(x: int) -> int:
    """A Python int wrapped to int32, as the reference's int32 math."""
    return (int(x) + 2**31) % 2**32 - 2**31


def _check(name, t, dtype, ndim, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _dir_matrix_batch(prof_t, targets, go, ge, algorithm, lengths):
    """Packed direction matrices for a padded batch of pairs (T1).

    Arguments:
        prof_t: ``(Q, A)`` int32 profile (the matrix rows of the query).
        targets: ``(B, T_pad)`` int32 symbols, each below ``A``.
        lengths: ``(B,)`` int32 target lengths.  Columns at or beyond a
            pair's length are 0 (no walk decision reads them).

    Returns ``(B, Q, T_pad) uint8``, byte ``[b, i - 1, j - 1]`` for the
    DP cell ``(i, j)``, equal to the reference's on every column below
    the pair's length.  On CUDA tensors it is one T1 launch (none for an
    empty batch) into a ``torch.empty`` buffer of ``(B, T_pad, Qs)``
    bytes, ``Qs = Q`` rounded up to 16, every byte of which T1 writes; the
    result is its transposed view (strides ``(T_pad * Qs, 1, Qs)``), which
    `_walk_batch_device` walks as it is.  On the CPU the result is
    contiguous.
    """
    dev = prof_t.device
    _check("prof_t", prof_t, torch.int32, 2, dev)
    _check("targets", targets, torch.int32, 2, dev)
    _check("lengths", lengths, torch.int32, 1, dev)
    if lengths.shape[0] != targets.shape[0]:
        raise ValueError("lengths must be (B,)")
    if algorithm not in ALGO_CODES:
        raise ValueError(f"invalid algorithm: {algorithm!r}")
    if dev.type == "cpu":
        plain_calls["traceback_dirs"] += 1
        return dir_matrix_reference(
            prof_t, targets, go, ge, algorithm, lengths
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    Q, A = prof_t.shape
    B, T_pad = targets.shape
    if B == 0 or Q == 0 or T_pad == 0:
        return torch.zeros((B, Q, T_pad), dtype=torch.uint8, device=dev)
    from . import _cuda

    Qs = _round_up_16(Q)
    G = dirs_group(Q)
    store = torch.empty((B, T_pad, Qs), dtype=torch.uint8, device=dev)
    # H and F of each pass's last row at every column, for the next pass
    rowbuf = (
        torch.empty((B, 2, T_pad), dtype=torch.int32, device=dev)
        if Q > G * DIRS_R else 0
    )
    _cuda.launch(
        "traceback_dirs", prof_t, targets, lengths, store, rowbuf,
        B, Q, Qs, A, T_pad, G, int(go), int(ge), ALGO_CODES[algorithm],
    )
    launches["traceback_dirs"] += 1
    return store.transpose(1, 2)[:, :Q]


def dirs_storage(dirs):
    """T1's ``(B, T_pad, Qs)`` bytes behind a ``(B, Qd, T_pad)`` tensor of
    direction bytes, and ``Qs``: the tensor's own storage when it is T1's
    view, else a transposed copy with ``Qs = Qd`` rounded up to 16 (rows
    past ``Qd`` zero)."""
    B, Qd, T_pad = dirs.shape
    Qs = dirs.stride(2)
    if (dirs.stride(1) == 1 and Qs % 16 == 0 and Qs >= Qd
            and dirs.stride(0) == T_pad * Qs
            and dirs.storage_offset() == 0):
        store = torch.as_strided(dirs, (B, T_pad, Qs), (T_pad * Qs, Qs, 1))
        return store, Qs
    Qs = _round_up_16(Qd)
    store = torch.zeros((B, T_pad, Qs), dtype=torch.uint8, device=dirs.device)
    store[:, :, :Qd] = dirs.transpose(1, 2)
    return store, Qs


def dir_matrix_reference(prof_t, targets, go, ge, algorithm, lengths):
    """T1's plain version: the reference's column scan on tensors.

    The DP state is ``(Q+1, B)``; each target column is one step, with
    F by the prefix-max form of the reference (``torch.cummax``) and the
    gap-open bits derived from the same comparisons.  Same arguments and
    result as `_dir_matrix_batch`, on any device.
    """
    spec = ALGORITHMS[algorithm]
    Q, A = prof_t.shape
    B, T_pad = targets.shape
    dev = prof_t.device
    i32 = torch.int32
    go, ge = _i32(go), _i32(ge)
    gmin = min(go, ge)

    rows = torch.arange(Q + 1, dtype=i32, device=dev)[:, None]
    if spec.penalize_first_col:
        col0 = torch.where(
            rows > 0, -(go + (rows - 1) * ge), torch.zeros_like(rows)
        )
    else:
        col0 = torch.zeros((Q + 1, 1), dtype=i32, device=dev)
    H = col0.expand(Q + 1, B).contiguous()
    E = torch.full((Q + 1, B), int(NEG), dtype=i32, device=dev)
    off = rows * gmin
    neg_row = torch.full((1, B), int(NEG), dtype=i32, device=dev)
    syms = targets.t().long()  # (T_pad, B)
    out = torch.empty((T_pad, Q, B), dtype=torch.uint8, device=dev)

    for j in range(1, T_pad + 1):
        prof_col = prof_t.index_select(1, syms[j - 1])  # (Q, B), exact
        hg = H - go
        eg = E - ge
        E_new = torch.maximum(hg, eg)
        e_open = hg >= eg  # tie -> open, like the oracle

        r0 = _i32(-(go + (j - 1) * ge)) if spec.penalize_first_row else 0
        row0 = torch.full((1, B), r0, dtype=i32, device=dev)

        diag = H[:-1] + prof_col  # rows 1..Q
        tmp = torch.maximum(diag, E_new[1:])
        if spec.clamp_zero:
            tmp = tmp.clamp_min(0)
        tmp_full = torch.cat([row0, tmp])

        cmax = torch.cummax(tmp_full + off, dim=0).values
        F_rows = cmax[:-1] - go - off[:-1]  # F[i], i = 1..Q

        H_rows = torch.maximum(tmp, F_rows)
        H_new = torch.cat([row0, H_rows])

        # F gap-open bits: F[i] from H_new[i-1] (open) vs F[i-1] (extend)
        f_prev = torch.cat([neg_row, F_rows[:-1]])
        f_open = (H_new[:-1] - go) >= (f_prev - ge)

        code = torch.where(
            H_rows == diag,
            DIR_DIAG,
            torch.where(H_rows == E_new[1:], DIR_E, DIR_F),
        )
        if spec.clamp_zero:
            code = torch.where(H_rows == 0, DIR_STOP, code)
        out[j - 1] = (code + e_open[1:] * E_OPEN + f_open * F_OPEN).to(
            torch.uint8
        )
        H, E = H_new, E_new

    dirs = out.permute(2, 1, 0).contiguous()  # (B, Q, T_pad)
    cols = torch.arange(T_pad, device=dev)
    dirs *= (cols[None, :] < lengths[:, None]).to(torch.uint8)[:, None]
    return dirs


def _walk(dirs, spec, qs_hint, qe, te, go, ge):
    """Host walk from the end cell; returns (q_start, t_start, ops)."""
    i, j = qe + 1, te + 1
    ops = []
    state = "H"
    while i > 0 or j > 0:
        if state == "H":
            if i == 0:
                if spec.penalize_first_row:
                    ops.append(OP_INS)
                    j -= 1
                    continue
                break
            if j == 0:
                if spec.penalize_first_col:
                    ops.append(OP_DEL)
                    i -= 1
                    continue
                break
            d = int(dirs[i - 1, j - 1])
            code = d & 3
            if code == DIR_STOP:
                break
            if code == DIR_DIAG:
                ops.append(OP_MATCH)  # refined to X by the caller
                i -= 1
                j -= 1
            elif code == DIR_E:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            ops.append(OP_INS)
            opened = bool(dirs[i - 1, j - 1] & E_OPEN) if i > 0 else True
            j -= 1
            if opened:
                state = "H"
            # else stay in E: next iteration reads dirs[i-1, j-1] of the
            # new column for the chained open bit
        else:  # state == "F"
            ops.append(OP_DEL)
            opened = bool(dirs[i - 1, j - 1] & F_OPEN) if j > 0 else True
            i -= 1
            if opened:
                state = "H"
    return i, j, ops[::-1]


def _walk_batch_device(dirs, qes, tes, algorithm):
    """Batched walk over resident direction matrices (T2).

    Arguments:
        dirs: ``(B, Qd, T_pad)`` uint8 direction bytes (`_dir_matrix_batch`'s
            result: on CUDA tensors T1's transposed view, walked as it is;
            any other layout is first copied into it, `dirs_storage`).
        qes / tes: ``(B,)`` int32 end cells (0-based; ``(-1, -1)`` for a
            pair the walk does not serve, which finishes at once).

    Returns ``(buf, i, j)``: ``buf[s, b]`` (uint8, ``(LMAX, B)`` with
    ``LMAX = 2 (Qd + T_pad) + 4``) is pair ``b``'s op at step ``s`` (255 =
    none; ops are emitted end to start), and ``(i, j)`` (int32) are the
    1-based start cells.  On CUDA tensors it is one T2 launch (none for
    an empty batch) into a ``torch.empty`` buffer of ``(B, LMAX_s)``
    bytes, ``LMAX_s = LMAX`` rounded up to 16, every byte of which T2
    writes; ``buf`` is its transposed view.  On the CPU ``buf`` is
    contiguous.
    """
    dev = dirs.device
    if dirs.dtype != torch.uint8:
        raise TypeError(f"dirs must be {torch.uint8}, got {dirs.dtype}")
    if dirs.ndim != 3:
        raise ValueError("dirs must have 3 dimensions")
    _check("qes", qes, torch.int32, 1, dev)
    _check("tes", tes, torch.int32, 1, dev)
    B = dirs.shape[0]
    if qes.shape[0] != B or tes.shape[0] != B:
        raise ValueError("qes and tes must be (B,)")
    if algorithm not in ALGO_CODES:
        raise ValueError(f"invalid algorithm: {algorithm!r}")
    if dev.type == "cpu":
        plain_calls["traceback_walk"] += 1
        return walk_reference(dirs, qes, tes, algorithm)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _, Qd, T_pad = dirs.shape
    lmax = 2 * (Qd + T_pad) + 4
    lmax_s = _round_up_16(lmax)
    store = torch.empty((B, lmax_s), dtype=torch.uint8, device=dev)
    i_out = torch.empty(B, dtype=torch.int32, device=dev)
    j_out = torch.empty(B, dtype=torch.int32, device=dev)
    buf = store.t()[:lmax]
    if B == 0:
        return buf, i_out, j_out
    from . import _cuda

    d_store, Qs = dirs_storage(dirs)
    _cuda.launch(
        "traceback_walk", d_store, qes, tes, store, i_out, j_out,
        B, Qd, Qs, T_pad, lmax, lmax_s, ALGO_CODES[algorithm],
    )
    launches["traceback_walk"] += 1
    return buf, i_out, j_out


#: steps of `walk_reference` between its checks that every pair is done
_DONE_CHECK = 16


def walk_reference(dirs, qes, tes, algorithm):
    """T2's plain version: the reference's lock-stepped walk on tensors.

    Same arguments and result as `_walk_batch_device`, on any device.
    Every pair steps together until all are done or ``LMAX`` steps have
    run; a done pair emits 255 and keeps its cell, so checking for the
    end every `_DONE_CHECK` steps gives the same buffer.
    """
    spec = ALGORITHMS[algorithm]
    B, Qd, T_pad = dirs.shape
    dev = dirs.device
    flat = dirs.reshape(B, Qd * T_pad)
    lmax = 2 * (Qd + T_pad) + 4
    i = qes.long() + 1
    j = tes.long() + 1
    st = torch.zeros(B, dtype=torch.long, device=dev)  # 0=H, 1=E, 2=F
    done = (i == 0) & (j == 0)
    buf = torch.full((lmax, B), 255, dtype=torch.uint8, device=dev)
    hi = max(Qd * T_pad - 1, 0)
    false = torch.zeros(B, dtype=torch.bool, device=dev)

    for s in range(lmax):
        if s % _DONE_CHECK == 0 and bool(done.all()):
            break
        idx = ((i - 1) * T_pad + (j - 1)).clamp(0, hi)
        if Qd * T_pad:
            d = flat.gather(1, idx[:, None])[:, 0].long()
        else:
            d = torch.zeros(B, dtype=torch.long, device=dev)
        code = d & 3
        in_H = (st == 0) & ~done
        in_E = (st == 1) & ~done
        in_F = (st == 2) & ~done
        i_is0 = i == 0
        j_is0 = j == 0

        # H-state boundary and inner sub-cases (mirrors `_walk` exactly)
        h_ins = (in_H & i_is0) if spec.penalize_first_row else false
        h_stop_i0 = false if spec.penalize_first_row else (in_H & i_is0)
        h_del = (
            (in_H & ~i_is0 & j_is0) if spec.penalize_first_col else false
        )
        h_stop_j0 = (
            false if spec.penalize_first_col else (in_H & ~i_is0 & j_is0)
        )
        h_inner = in_H & ~i_is0 & ~j_is0
        h_stop_clamp = (
            (h_inner & (code == DIR_STOP)) if spec.clamp_zero else false
        )
        h_diag = h_inner & (code == DIR_DIAG)
        h_toE = h_inner & (code == DIR_E)
        h_toF = h_inner & (code == DIR_F) & ~h_stop_clamp

        e_open = torch.where(i > 0, (d & E_OPEN) != 0, True)
        f_open = torch.where(j > 0, (d & F_OPEN) != 0, True)

        emit = torch.full((B,), 255, dtype=torch.uint8, device=dev)
        emit = torch.where(h_ins | in_E, OP_INS, emit)
        emit = torch.where(h_del | in_F, OP_DEL, emit)
        emit = torch.where(h_diag, OP_MATCH, emit)

        i = i - (h_del | h_diag | in_F).long()
        j = j - (h_ins | h_diag | in_E).long()
        done = (
            done | h_stop_i0 | h_stop_j0 | h_stop_clamp
            | ((i == 0) & (j == 0))
        )
        st = torch.where(
            h_toE, 1,
            torch.where(
                h_toF, 2,
                torch.where(
                    in_E, torch.where(e_open, 0, 1),
                    torch.where(in_F, torch.where(f_open, 0, 2), st),
                ),
            ),
        )
        buf[s] = emit
    return buf, i.to(torch.int32), j.to(torch.int32)


def full_alignment(query_enc, target_enc, matrix, go, ge, algorithm):
    """(score, q_start, t_start, q_end, t_end, ops uint8 array).

    Scalar fallback used for a single pair; batched searches use
    `full_alignments_batch`.
    """
    return naive.traceback(
        np.asarray(query_enc, dtype=np.uint8),
        np.asarray(target_enc, dtype=np.uint8),
        matrix,
        go,
        ge,
        algorithm,
    )


def plan_batches(Q: int, target_lengths):
    """The reference's batching of one query's pairs: ``(batches,
    scalar)``, lists of target positions.

    Pairs are taken by length; a pair whose padded direction matrix
    alone exceeds `MAX_DEVICE_CELLS` goes to ``scalar`` (`naive.traceback`),
    and a batch is closed before the next pair would make its padded
    allocation exceed it.  The accounting uses the padded allocation shape
    (batch rounded to a power of two, columns to the 128 quantum, every
    row padded to the batch max), not the raw cell count, as the
    reference's does, so the same pairs take the same path.
    """
    def _alloc(nb, tmax):
        b_pow2 = 1 << max(nb - 1, 0).bit_length()
        return b_pow2 * _round_up_128(tmax) * max(Q, 1)

    order = sorted(range(len(target_lengths)),
                   key=lambda i: target_lengths[i])
    batch, batch_tmax = [], 1
    batches, scalar = [], []
    for i in order:
        t_pad = max(int(target_lengths[i]), 1)
        if _alloc(1, t_pad) > MAX_DEVICE_CELLS:
            scalar.append(i)
            continue
        if batch and _alloc(
            len(batch) + 1, max(batch_tmax, t_pad)
        ) > MAX_DEVICE_CELLS:
            batches.append(batch)
            batch, batch_tmax = [], 1
        batch.append(i)
        batch_tmax = max(batch_tmax, t_pad)
    if batch:
        batches.append(batch)
    return batches, scalar


def pad_batch(targets, batch):
    """A batch's ``(B, T_pad)`` int32 symbols and ``(B,)`` lengths at the
    reference's padded shape: columns to the 128 quantum, ``B`` to a
    power of two (zero-length padding pairs)."""
    t_pad = _round_up_128(max(max(len(targets[i]) for i in batch), 1))
    B = 1 << (len(batch) - 1).bit_length()
    tgt = np.zeros((B, t_pad), dtype=np.int32)
    tlen = np.zeros(B, dtype=np.int32)
    for k, i in enumerate(batch):
        seq = targets[i]
        tgt[k, : len(seq)] = seq
        tlen[k] = len(seq)
    return tgt, tlen


def walk_ends(targets, batch, B, Q, q_ends, t_ends, algorithm):
    """The ``(B,)`` int32 end cells T2 starts from: the score pass's
    ends, and ``(-1, -1)``, which finishes at once, for pairs the walk
    does not serve (empty targets or query, sw's empty alignments, the
    padding pairs).  Semi-global ends on the j = 0 boundary (te = -1)
    are walked from column 0, as the oracle does."""
    qes = np.full(B, -1, np.int32)
    tes = np.full(B, -1, np.int32)
    for k, i in enumerate(batch):
        if len(targets[i]) == 0 or Q == 0:
            continue
        qe, te = int(q_ends[i]), int(t_ends[i])
        if algorithm == "sw" and (qe < 0 or te < 0):
            continue
        qes[k], tes[k] = qe, te
    return qes, tes


def full_alignments_batch(
    query_enc, targets, matrix, go, ge, algorithm, ends, device="cuda"
):
    """Batched reconstruction for one query against many targets.

    Arguments:
        targets: list of encoded target arrays.
        ends: ``(scores, q_ends, t_ends)`` from the score pass.
        device: where T1 and T2 (or, on the CPU, their plain versions)
            run.

    Returns a list of ``(score, qs, ts, qe, te, ops)`` tuples matching
    the scalar oracle exactly.
    """
    device = torch.device(device)
    scores, q_ends, t_ends = ends
    query_enc = np.asarray(query_enc, dtype=np.uint8)
    Q = query_enc.shape[0]
    S = np.asarray(matrix, dtype=np.int32)
    prof_t = S[query_enc.astype(np.int64), :]  # (Q, A)
    prof_dev = torch.from_numpy(np.ascontiguousarray(prof_t)).to(device)

    out = [None] * len(targets)
    batches, scalar = plan_batches(Q, [len(t) for t in targets])
    for i in scalar:
        # a single pair over budget takes the scalar fallback
        out[i] = naive.traceback(
            query_enc, targets[i], matrix, go, ge, algorithm
        )

    for batch in batches:
        tgt, tlen = pad_batch(targets, batch)
        dirs_dev = _dir_matrix_batch(
            prof_dev,
            torch.from_numpy(tgt).to(device),
            int(go),
            int(ge),
            algorithm,
            torch.from_numpy(tlen).to(device),
        )
        qes, tes = walk_ends(
            targets, batch, tgt.shape[0], Q, q_ends, t_ends, algorithm
        )
        buf, i_start, j_start = _walk_batch_device(
            dirs_dev,
            torch.from_numpy(qes).to(device),
            torch.from_numpy(tes).to(device),
            algorithm,
        )
        del dirs_dev
        buf = buf.cpu().numpy()
        i_start = i_start.cpu().numpy()
        j_start = j_start.cpu().numpy()
        for k, i in enumerate(batch):
            target = targets[i]
            score = int(scores[i])
            if len(target) == 0 or Q == 0:
                # degenerate pair: delegate to the scalar oracle
                out[i] = naive.traceback(
                    query_enc, target, matrix, go, ge, algorithm
                )
                continue
            qe, te = int(q_ends[i]), int(t_ends[i])
            if algorithm == "sw" and (qe < 0 or te < 0):
                # empty local alignment (score 0)
                out[i] = (score, 0, 0, qe, te, np.zeros(0, np.uint8))
                continue
            col = buf[:, k]
            ops = col[col != 255][::-1]  # emitted end-to-start
            qs, ts = int(i_start[k]), int(j_start[k])
            # refine M -> X where residues differ (vectorized)
            ops = np.asarray(ops, dtype=np.uint8)
            consumes_q = ops != OP_INS
            consumes_t = ops != OP_DEL
            qpos = qs + np.cumsum(consumes_q) - consumes_q
            tpos = ts + np.cumsum(consumes_t) - consumes_t
            # only index at match positions: after the final residue is
            # consumed, trailing gap ops carry positions one past the end
            m = np.nonzero(ops == OP_MATCH)[0]
            tarr = np.asarray(target)
            mism = query_enc[qpos[m]] != tarr[tpos[m]]
            ops[m[mism]] = OP_MISMATCH
            # the walked path must span exactly [qs, qe] x [ts, te]: a
            # kernel/traceback divergence guard that, like
            # engine._full_rows_for's score cross-check, fires under -O
            # too (never a bare assert)
            qi = qs + int(consumes_q.sum())
            ti = ts + int(consumes_t.sum())
            if qi != qe + 1 or ti != te + 1:
                raise RuntimeError(
                    f"inconsistent traceback span for target {i}: "
                    f"walked to ({qi},{ti}), expected ({qe + 1},{te + 1})"
                )
            out[i] = (score, qs, ts, qe, te, ops)
    return out
