"""Segmented kernel for one long query over the flat packed database (K3).

Port of ``pyopal_tpu/ops/pallas_ragged_long.py``: `search_flat_long`
(l.445) with the per-segment launch `_segment_call` (l.336) and its
kernel `_seg_kernel` (l.49).  A query whose fine-tier K1 launch is over
budget (`ragged.supports_fine`) is searched in segments of `QSEG` query
rows, one kernel launch per segment, in order.  Between segments the
state lives in device memory:

- ``hb``/``fb``: H and F of the segment's last row at every target
  column, shaped like the flat targets ``(total_rows, lanes)``; the next
  segment reads them as the row above its first row;
- ``trk``: the trackers ``(best, cap, bi, bj, ci)``, ``(5, n_blocks,
  lanes)``, resumed by the next segment.

The reference keeps this state in f32; the port keeps it in int32, which
is exact.  The kernel is hand-written CUDA C++ in
``csrc/ragged_long.cu``, K1's wavefront walk (``csrc/wave.cuh``) over the
segment's rows in passes of 256; its design is described there.

As in `pyopal_tpu_torch.ops.ragged`:

- `search_segment`, the wrapper: it checks its inputs, launches the
  kernel for CUDA tensors and counts `launches` (one per segment: the
  walk keeps no scratch); for CPU tensors it runs the plain version and
  counts `plain_calls`.  A CUDA tensor never falls back.
- `segment_reference`, the plain PyTorch version of one segment: a
  column sweep over the segment's rows with ``torch.cummax`` for F,
  seeded from the carried row above.  It takes and returns the same
  state as the kernel, so the two compare segment by segment.
- `wave_segment_reference`, the segment as the kernel computes it
  (``ragged.wave_walk_reference``): for the tests only.
- `search_flat_long` / `search_flat_long_reference`: every segment of
  one query, through the wrapper or the plain version.

Outputs follow the reference: ``(n_blocks, lanes)`` int32 scores, query
ends and target ends for sw/nw/hw/ov, with the sweep order's tie rule
kept across segments.  In score-only mode no position is tracked, and the
end planes hold what the reference's finalize writes then: nw ``Q - 1``
and ``len - 1``, hw ``Q - 1`` and -1, ov ``Q - 1`` and -1 or, where the
last column wins, -1 and ``len - 1``, sw -1 and -1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import ALGORITHMS
from ..utils.profiling import count, span, spanned
from . import sweep
from .ragged import (
    ALGO_CODES,
    ALPHA,
    WAVE_R,
    check_flat,
    make_profiles_host,
    wave_finish,
    wave_group,
    wave_start,
    wave_walk_reference,
)

#: query rows per segment (reference ``QSEG``; read at call time, so a
#: test may lower it)
QSEG = 2048
NEG = sweep.NEG
#: tracker rows of ``trk``: best, cap, bi, bj, ci
N_TRACK = 5

#: plain-version runs made by the wrapper on CPU tensors
plain_calls = 0
#: kernel launches made by `search_segment` on CUDA tensors
launches = 0


def _check_segment(prof, Q, seg_off, flat_targets, lengths, bos, cos, los,
                   hb, fb, trk, algorithm):
    dev = prof.device
    check_flat(flat_targets, lengths, bos, cos, los, dev)
    n_blocks, _, lanes = lengths.shape
    for name, t, shape in (
        ("prof", prof, None),
        ("hb", hb, tuple(flat_targets.shape)),
        ("fb", fb, tuple(flat_targets.shape)),
        ("trk", trk, (N_TRACK, n_blocks, lanes)),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}")
    if prof.ndim != 2 or prof.shape[1] != ALPHA or prof.shape[0] == 0:
        raise ValueError(f"prof must be (rows, {ALPHA}) with rows > 0")
    if not 0 <= seg_off < Q:
        raise ValueError(f"segment offset {seg_off} outside a {Q}-row query")
    if algorithm not in ALGO_CODES:
        raise ValueError(f"invalid algorithm: {algorithm!r}")


def search_segment(
    prof,
    Q,
    seg_off,
    flat_targets,
    lengths,
    bos,
    cos,
    los,
    hb,
    fb,
    trk,
    go,
    ge,
    algorithm,
    with_ends,
    chunk=64,
):
    """Rows ``[seg_off, seg_off + rows)`` of a ``Q``-row query x the whole
    flat-packed database, ``rows = min(len(prof), Q - seg_off)``.

    Arguments:
        prof: ``(rows_pad, 32)`` int32 profile rows of this segment
            (`ragged.make_profiles_host` of the query at a multiple of
            the segment height); rows past the query are not read.
        Q / seg_off: the query's length and the segment's first row.
        flat_targets / lengths / bos / cos / los / chunk: the flat pack
            (`ragged.search_flat`).
        hb / fb: ``(total_rows, lanes)`` int32 H and F of row
            ``seg_off - 1`` at every target column (the previous
            segment's output); not read when ``seg_off == 0``.
        trk: ``(5, n_blocks, lanes)`` int32 trackers of the previous
            segment; not read when ``seg_off == 0``.

    Returns:
        ``(scores, q_ends, t_ends, hb, fb, trk)``: the answer as if the
        query ended with this segment's trackers (``(n_blocks, lanes)``
        int32 each; the last segment's is the search's), and the state
        for the next segment.  Positions of ``hb``/``fb`` past a
        target's length keep the values passed in.
    """
    global launches, plain_calls
    _check_segment(prof, Q, seg_off, flat_targets, lengths, bos, cos, los,
                   hb, fb, trk, algorithm)
    dev = prof.device
    if dev.type == "cpu":
        plain_calls += 1
        return segment_reference(
            prof, Q, seg_off, flat_targets, lengths, bos, cos, los, hb, fb,
            trk, go, ge, algorithm, with_ends, chunk,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")

    from . import _cuda

    rows = min(prof.shape[0], Q - seg_off)
    n_blocks, _, lanes = lengths.shape
    row_off = sweep.block_row_offsets(bos, n_blocks, chunk)
    outs = [
        torch.empty((n_blocks, lanes), dtype=torch.int32, device=dev)
        for _ in range(3)
    ]
    # the walk's passes update hb_out/fb_out in place (no scratch)
    hb_out, fb_out = hb.clone(), fb.clone()
    trk_out = torch.empty_like(trk)
    _cuda.launch(
        "ragged_long",
        prof, flat_targets, lengths, row_off, hb, fb, hb_out, fb_out,
        trk, trk_out, *outs,
        int(Q), int(seg_off), rows, prof.shape[0], n_blocks, lanes,
        wave_group(rows), int(go), int(ge), ALGO_CODES[algorithm],
        int(bool(with_ends)),
    )
    launches += 1
    return (*outs, hb_out, fb_out, trk_out)


def segment_reference(
    prof,
    Q,
    seg_off,
    flat_targets,
    lengths,
    bos,
    cos,
    los,
    hb,
    fb,
    trk,
    go,
    ge,
    algorithm,
    with_ends,
    chunk=64,
):
    """Plain PyTorch version of `search_segment` (same inputs, outputs).

    A column sweep over the segment's rows, vectorized over rows and the
    lanes still inside their target (lanes visited in length order).
    The vertical gap follows the identity of `ops.sweep`, with the F
    entering the segment's first row as the prefix max's first term:
    ``max(hb - go, fb - ge)``, or on the first segment the closed-form
    row 0 less ``go``.
    """
    del cos, los
    spec = ALGORITHMS[algorithm]
    dev = prof.device
    i32 = torch.int32
    go, ge = int(go), int(ge)
    gmin = min(go, ge)
    rows = min(prof.shape[0], Q - seg_off)
    first = seg_off == 0
    has_last = seg_off + rows == Q
    n_blocks, _, lanes = lengths.shape
    N = n_blocks * lanes

    lens_h = lengths.reshape(-1).cpu().numpy().astype(np.int64)
    order = np.argsort(lens_h, kind="stable")
    sorted_lens = lens_h[order]
    t_max = int(sorted_lens[-1]) if N else 0
    first_active = np.searchsorted(sorted_lens, np.arange(t_max), "right")
    perm = torch.as_tensor(order, device=dev)
    lens = torch.as_tensor(sorted_lens, device=dev).to(i32)
    idx = sweep.flat_index(lengths, bos, chunk, flat_targets.shape[0])
    idx = idx[:, perm]
    tgt = flat_targets.reshape(-1)[idx]
    hb_in, fb_in = hb.reshape(-1), fb.reshape(-1)
    hb_out, fb_out = hb.clone(), fb.clone()
    hb_o, fb_o = hb_out.reshape(-1), fb_out.reshape(-1)

    # H of the row above (row 0 here) and of the segment's rows at the
    # previous column; the row above starts at its first-column boundary
    r = torch.arange(rows + 1, device=dev, dtype=i32)[:, None]
    grow = r[1:] + seg_off - 1  # query row of each segment row
    if spec.penalize_first_col:
        H = torch.cat([-(go + (r[:1] + seg_off - 1) * ge), -(go + grow * ge)])
        if first:
            H[0] = 0
    else:
        H = torch.zeros((rows + 1, 1), dtype=i32, device=dev)
    H = H.to(i32).expand(rows + 1, N).clone()
    E = torch.full((rows, N), NEG, dtype=i32, device=dev)

    if first:
        empty = -(go + (Q - 1) * ge)
        init = (empty if algorithm == "hw" else 0,
                empty if algorithm == "nw" else NEG, -1, -1, -1)
        best, cap, bi, bj, ci = (
            torch.full((N,), v, dtype=i32, device=dev) for v in init
        )
    else:
        best, cap, bi, bj, ci = trk.reshape(N_TRACK, N)[:, perm].clone()
    seg_rows = torch.arange(rows, device=dev, dtype=i32)[:, None]
    prof = prof[:rows]

    for j in range(t_max):
        k = int(first_active[j])
        at = idx[j, k:]
        if first:
            hup = -(go + j * ge) if spec.penalize_first_row else 0
            hup = torch.full((N - k,), hup, dtype=i32, device=dev)
            f_top = hup - go
        else:
            hup = hb_in[at]
            f_top = torch.maximum(hup - go, fb_in[at] - ge)
        Hs = H[:, k:]
        E_new = torch.maximum(Hs[1:] - go, E[:, k:] - ge)
        tmp = torch.maximum(
            Hs[:-1] + prof.index_select(1, tgt[j, k:].long()), E_new
        )
        if spec.clamp_zero:
            tmp.clamp_(min=0)
        # F[i] = max(F[0] - i*gmin, max_{m < i} tmp[m] - go - (i-1-m)*gmin)
        tmp_full = torch.cat([(f_top + go)[None], tmp])
        cmax = torch.cummax(tmp_full + r * gmin, dim=0).values
        F = cmax[:-1] - go - r[:-1] * gmin
        H_rows = torch.maximum(tmp, F)
        H[1:, k:] = H_rows
        H[0, k:] = hup
        E[:, k:] = E_new
        hb_o[at] = H_rows[-1]
        fb_o[at] = F[-1]

        at_end = lens[k:] == j + 1
        if spec.track_all_cells or spec.track_last_col:
            colmax = H_rows.max(dim=0).values
            coli = torch.where(H_rows == colmax, seg_rows, rows).amin(0)
            coli = coli + seg_off
        if spec.track_all_cells:  # sw
            if with_ends:
                upd = (colmax > best[k:]) | (
                    (colmax == best[k:]) & (j < bj[k:])
                )
                bi[k:] = torch.where(upd, coli, bi[k:])
                bj[k:] = torch.where(upd, j, bj[k:])
            best[k:] = torch.maximum(best[k:], colmax)
        if spec.track_last_row and has_last:  # hw / ov
            upd = H_rows[-1] > best[k:]
            best[k:] = torch.where(upd, H_rows[-1], best[k:])
            bj[k:] = torch.where(upd, j, bj[k:])
        if spec.track_terminal and has_last:  # nw
            cap[k:] = torch.where(at_end, H_rows[-1], cap[k:])
        if spec.track_last_col:  # ov
            upd = at_end & (colmax > cap[k:])
            cap[k:] = torch.where(upd, colmax, cap[k:])
            ci[k:] = torch.where(upd, coli, ci[k:])

    qlast = torch.full_like(best, Q - 1)
    # score mode tracks no position (the kernel's trackers still carry
    # hw/ov's columns to the next segment, unread)
    ei, ej, eci = (
        (bi, bj, ci) if with_ends else (torch.full_like(best, -1),) * 3
    )
    if algorithm == "sw":
        out = (best, ei, ej)
    elif algorithm == "nw":
        out = (cap, qlast, lens - 1)
    elif algorithm == "hw":
        out = (best, qlast, ej)
    else:  # ov: ties go to the last-row end
        use_col = cap > best
        out = (
            torch.maximum(best, cap),
            torch.where(use_col, eci, qlast),
            torch.where(use_col, lens - 1, ej),
        )
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(N, device=dev)
    scores, qe, te = (x[inv].reshape(n_blocks, lanes) for x in out)
    trk_out = torch.stack([best, cap, bi, bj, ci])[:, inv]
    return (
        scores, qe, te, hb_out, fb_out,
        trk_out.reshape(N_TRACK, n_blocks, lanes).contiguous(),
    )


def wave_segment_reference(
    prof,
    Q,
    seg_off,
    flat_targets,
    lengths,
    bos,
    cos,
    los,
    hb,
    fb,
    trk,
    go,
    ge,
    algorithm,
    with_ends,
    chunk=64,
    G=None,
    R=WAVE_R,
):
    """K3 as its CUDA kernel computes it: `ragged.wave_walk_reference`
    for every target lane, ``G`` threads of ``R`` rows each (``G``: the
    kernel's `ragged.wave_group` of the segment's rows by default), the
    passes updating ``hb_out``/``fb_out`` in place.  Same inputs and
    outputs as `search_segment`; CPU tensors only.  The tests hold it
    against the JAX package; no call path uses it."""
    del cos, los
    rows = min(prof.shape[0], Q - seg_off)
    G = wave_group(rows, R) if G is None else G
    n_blocks, _, lanes = lengths.shape
    N = n_blocks * lanes
    lens = lengths.reshape(-1).to(torch.int64)
    idx = sweep.flat_index(lengths, bos, chunk, flat_targets.shape[0])
    tgt = flat_targets.reshape(-1)[idx]
    hb_in, fb_in = (x.reshape(-1)[idx].to(torch.int64) for x in (hb, fb))
    pbuf_h, pbuf_f = hb_in.clone(), fb_in.clone()
    Qv = torch.full((N,), Q, dtype=torch.int64)
    trk_in = (wave_start(Qv, go, ge, algorithm) if seg_off == 0
              else trk.reshape(N_TRACK, N).to(torch.int64))
    trk_out = wave_walk_reference(
        prof.reshape(-1), prof.shape[0], torch.zeros(N, dtype=torch.int64),
        seg_off, torch.full((N,), rows, dtype=torch.int64), Qv, tgt, lens,
        hb_in, fb_in, pbuf_h, pbuf_f, go, ge, algorithm, with_ends, trk_in,
        G, R, True,
    )
    out = wave_finish(trk_out, Qv, lens, algorithm, with_ends, True)
    in_tgt = torch.arange(idx.shape[0])[:, None] < lens[None]
    hb_out, fb_out = hb.clone(), fb.clone()
    hb_out.reshape(-1)[idx[in_tgt]] = pbuf_h[in_tgt].to(torch.int32)
    fb_out.reshape(-1)[idx[in_tgt]] = pbuf_f[in_tgt].to(torch.int32)
    return (
        *(x.reshape(n_blocks, lanes) for x in out), hb_out, fb_out,
        trk_out.to(torch.int32).reshape(N_TRACK, n_blocks, lanes),
    )


def _search(segment, query_enc, matrix, flat_targets, lengths, bos, cos,
            los, go, ge, algorithm, with_ends, chunk):
    """Every segment of one query through ``segment``."""
    qseg = QSEG
    Q = int(np.asarray(query_enc).shape[0])
    if Q == 0:
        raise ValueError("search_flat_long needs a non-empty query")
    n_seg = -(-Q // qseg)
    dev = flat_targets.device
    with span("pyopal.profile"):
        count("profile.misses", 1)  # one query alone: no cache
        prof = torch.as_tensor(
            make_profiles_host([query_enc], matrix, q_pad=n_seg * qseg)[0]
        ).to(dev)
    n_blocks, _, lanes = lengths.shape
    hb = torch.zeros(flat_targets.shape, dtype=torch.int32, device=dev)
    fb = torch.full(flat_targets.shape, NEG, dtype=torch.int32, device=dev)
    trk = torch.zeros((N_TRACK, n_blocks, lanes), dtype=torch.int32,
                      device=dev)
    for s in range(n_seg):
        scores, qe, te, hb, fb, trk = segment(
            prof[s * qseg : (s + 1) * qseg], Q, s * qseg, flat_targets,
            lengths, bos, cos, los, hb, fb, trk, go, ge, algorithm,
            with_ends, chunk,
        )
    return scores, qe, te


@spanned("pyopal.launch")
def search_flat_long(
    query_enc,
    matrix,
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
    """Segmented search for one long query over a flat-packed database.

    ``query_enc`` is the encoded query (numpy), ``matrix`` the scoring
    matrix; the flat pack lies on the device to run on.  One
    `search_segment` per `QSEG` rows.  Returns ``(scores, q_ends,
    t_ends)`` of shape ``(n_blocks, lanes)`` int32.
    """
    return _search(search_segment, query_enc, matrix, flat_targets, lengths,
                   bos, cos, los, go, ge, algorithm, with_ends, chunk)


def search_flat_long_reference(
    query_enc,
    matrix,
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
    """`search_flat_long` through the plain version on any device."""
    return _search(segment_reference, query_enc, matrix, flat_targets,
                   lengths, bos, cos, los, go, ge, algorithm, with_ends,
                   chunk)
