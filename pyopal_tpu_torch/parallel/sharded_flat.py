"""Sharded flat search: the flat kernels over a mesh of database shards.

Port of ``pyopal_tpu/parallel/sharded_flat.py``.  The length-sorted
blocks of the flat layout (`pyopal_tpu_torch.ops.packing.flat_layout`)
are dealt to the mesh's shards by greedy LPT on padded sweep rows
(`shard_assignment`), each shard is padded to common shapes, and each
rank runs the flat kernels once per shard it owns, on that shard's
device: no communication while the kernels run, profiles copied to
every device, outputs all-gathered and reassembled into global target
order by a host-side permutation.

The packing is process-local: every rank computes the global layout (an
O(n) plan from the sequence lengths) but fills the uint8 payloads of its
own shards only (`pack_flat_sharded(..., local_shards=...)`), so a
rank's packed memory is O(database / ranks) at one byte per residue.

`_gidx_device` and `sharded_topk_candidates` are the candidate pipeline
of ``align_top_k_sharded``: each shard selects its best ``m`` scores per
query with `torch.topk` on its own device, and only those candidates are
gathered.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops import engine, packing, q8, ragged

LANES = 128


@dataclass
class ShardedFlat:
    """Flat-packed database distributed over ``n_shards``.

    Metadata arrays (lengths, step maps, index permutations) are
    global and stacked on a leading shard axis, padded to common
    shapes; ``inv_shard``/``inv_pos`` map each global target index to
    (shard, block*lanes+lane).  The symbol ``payloads`` are held only
    for the shards in ``local_shards`` (every shard in single-process
    use), as ``(rows_max, lanes)`` uint8 arrays.
    """

    n_targets: int
    n_shards: int
    rows_max: int
    lanes: int
    payloads: Dict[int, np.ndarray]  # shard -> (rows_max, lanes) uint8
    lengths: np.ndarray  # (n_shards, nblk_max, 1, lanes) int32
    block_of_step: np.ndarray  # (n_shards, steps_max) int32
    chunk_of_step: np.ndarray  # (n_shards, steps_max) int32
    last_of_step: np.ndarray  # (n_shards, steps_max) int32
    inv_shard: np.ndarray  # (n_targets,) int32
    inv_pos: np.ndarray  # (n_targets,) int32
    chunk: int = 64  # column-chunk quantum of the per-shard layouts
    local_shards: Optional[tuple] = None  # None = all shards local

    @property
    def local_payload_bytes(self) -> int:
        """Bytes of packed symbol payload materialized in this process."""
        return sum(int(p.nbytes) for p in self.payloads.values())


def shard_assignment(n: int, seq_lengths, n_shards: int, lanes: int):
    """Deal length-sorted blocks of ``lanes`` targets by greedy LPT.

    Blocks are formed over the length-sorted order (so lanes within a
    block stay similar: the padding-waste property), then assigned
    longest-block-first to the currently least-loaded shard, with the
    block's padded row count as its cost: the longest-processing-time
    heuristic.

    Returns one list of global target indices per shard.  A pure,
    deterministic function of the lengths: every rank computes the
    same plan.
    """
    order = sorted(range(n), key=lambda i: seq_lengths[i])
    blocks = [order[s : s + lanes] for s in range(0, n, lanes)]
    # cost = the block's padded sweep rows (its longest member, in
    # 64-column chunks)
    costs = [
        -(-max(seq_lengths[i] for i in ids) // 64) * 64
        for ids in blocks
    ]
    load = [0] * n_shards
    shard_ids: List[List[int]] = [[] for _ in range(n_shards)]
    for b in sorted(range(len(blocks)), key=lambda b: (-costs[b], b)):
        s = min(range(n_shards), key=lambda t: (load[t], t))
        load[s] += costs[b]
        shard_ids[s].extend(blocks[b])
    return shard_ids


def pack_flat_sharded(
    sequences,
    n_shards: int,
    lanes: int = LANES,
    local_shards=None,
) -> ShardedFlat:
    """Distribute encoded sequences over ``n_shards`` flat layouts.

    ``lanes`` selects the per-shard block width (128 for K1, 512/256 for
    K2, by query tier).  ``local_shards`` restricts payload
    materialization to the given shard indices (the shards of this rank:
    `local_shards_of_mesh`); metadata is always computed for every
    shard.  `None` materializes all shards (single-process use).
    """
    n = len(sequences)
    seq_lengths = [len(s) for s in sequences]
    shard_ids = shard_assignment(n, seq_lengths, n_shards, lanes)
    if local_shards is None:
        local = tuple(range(n_shards))
    else:
        local = tuple(sorted(set(int(s) for s in local_shards)))

    layouts = [
        packing.flat_layout([seq_lengths[i] for i in ids], lanes=lanes)
        for ids in shard_ids
    ]

    rows_max = max(max(lay.total_rows for lay in layouts), 128)
    nblk_max = max(max(lay.n_blocks for lay in layouts), 1)
    steps_max = max(max(lay.block_of_step.shape[0] for lay in layouts), 1)

    lengths = np.zeros((n_shards, nblk_max, 1, lanes), np.int32)
    bos = np.zeros((n_shards, steps_max), np.int32)
    cos = np.zeros((n_shards, steps_max), np.int32)
    los = np.ones((n_shards, steps_max), np.int32)
    inv_shard = np.zeros(n, np.int32)
    inv_pos = np.zeros(n, np.int32)
    payloads: Dict[int, np.ndarray] = {}

    for s, (layout, ids) in enumerate(zip(layouts, shard_ids)):
        lengths[s, : layout.n_blocks] = layout.lengths
        k = layout.block_of_step.shape[0]
        bos[s, :k] = layout.block_of_step
        cos[s, :k] = layout.chunk_of_step
        los[s, :k] = layout.last_of_step
        # padding steps point at the last block with chunk 0, not last
        # (the reference's grid needs them; the port's kernels read only
        # each block's first step)
        if k < steps_max:
            bos[s, k:] = layout.block_of_step[-1] if k else 0
            cos[s, k:] = 0
            los[s, k:] = 0
        for local_i, global_i in enumerate(ids):
            inv_shard[global_i] = s
            inv_pos[global_i] = layout.inv_pos[local_i]
        if s in local:
            pay = np.zeros((rows_max, lanes), np.uint8)
            pay[: layout.total_rows] = packing.fill_flat_payload(
                layout, [sequences[i] for i in ids]
            )
            payloads[s] = pay

    return ShardedFlat(
        n,
        n_shards,
        rows_max,
        lanes,
        payloads,
        lengths,
        bos,
        cos,
        los,
        inv_shard,
        inv_pos,
        chunk=layouts[0].chunk if layouts else 64,
        local_shards=None if local_shards is None else local,
    )


def local_shards_of_mesh(mesh) -> tuple:
    """Shard indices that this process's rank owns."""
    return tuple(s for s, r in enumerate(mesh.ranks) if r == mesh.rank)


def _gather_host(mesh, local: dict) -> np.ndarray:
    """Every shard's output, stacked in shard order, as a host array.

    ``local`` maps each of this rank's shards to its output tensor (one
    shape for all shards).  In a process group the rank's outputs are
    all-gathered (on the rank's device under NCCL, on the CPU under
    gloo); in a single process they are copied to the host.
    """
    mine = [local[s] for s in local_shards_of_mesh(mesh)]
    if not (dist.is_available() and dist.is_initialized()):
        return torch.stack([x.cpu() for x in mine]).numpy()
    dev = mine[0].device if dist.get_backend() == "nccl" else "cpu"
    mine = torch.stack([x.to(dev) for x in mine])
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return torch.cat([p.cpu() for p in parts]).numpy()


def _device_arrays(sf: ShardedFlat, mesh):
    """Each local shard's pack tensors on its device, cached on the pack
    (the mesh analog of ``engine._flat_device``): repeat searches against
    an unchanged database must not copy the payload again.

    Returns ``{shard: (flat_targets, lengths, bos, cos, los)}``.
    """
    cache = sf.__dict__.setdefault("_dev", {})
    hit = cache.get(mesh)
    if hit is None:
        local = local_shards_of_mesh(mesh)
        missing = [s for s in local if s not in sf.payloads]
        if missing:
            raise ValueError(
                f"pack is missing payloads for local shards {missing}; "
                "pass local_shards=local_shards_of_mesh(mesh) (or None) "
                "to pack_flat_sharded"
            )
        hit = {
            s: tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(mesh.devices[s])
                for a in (
                    sf.payloads[s], sf.lengths[s], sf.block_of_step[s],
                    sf.chunk_of_step[s], sf.last_of_step[s],
                )
            )
            for s in local
        }
        cache.clear()  # one mesh at a time; keep no stale device copies
        cache[mesh] = hit
    return hit


def _on(x, device):
    """``x`` (numpy or tensor) as a tensor on ``device``."""
    return torch.as_tensor(x).to(device)


def sharded_search_flat_device(
    mesh,
    profs,
    qlens,
    sf: ShardedFlat,
    go: int,
    ge: int,
    algorithm: str,
    with_ends: bool = True,
    safe_pad: bool = False,
    m_abs: Optional[int] = None,
):
    """`ragged.search_flat` once on each of this rank's shards, leaving
    the outputs on the shards' devices.

    ``profs``/``qlens`` are `ragged.make_profiles_host`'s profiles and
    the query lengths (numpy, or tensors on any device).  ``safe_pad``
    routes as in `ragged.search_flat`: K1 with it, K4 or K5 without it
    (the reference's default).  Given the matrix's largest absolute entry
    ``m_abs``, each shard takes K1's packed route where the engine's
    predicate admits it with that shard's longest target and lanes
    (`engine._ragged_packed_cap`).  Returns ``{shard: (scores, q_ends,
    t_ends)}``, each ``(n_q, nblk_max, lanes)`` int32.  The reference's
    ``interpret`` argument has no counterpart.
    """
    out = {}
    for s, (flat_t, lengths, bos, cos, los) in _device_arrays(
        sf, mesh
    ).items():
        dev = mesh.devices[s]
        cap = None if m_abs is None else engine._ragged_packed_cap(
            algorithm, with_ends, go, ge, m_abs, int(profs.shape[1]),
            int(sf.lengths[s].max(initial=0)), safe_pad, int(profs.shape[0]),
            sf.lengths[s].size,
        )
        out[s] = ragged.search_flat(
            _on(profs, dev), _on(qlens, dev), flat_t, lengths, bos, cos,
            los, int(go), int(ge), algorithm, with_ends, chunk=sf.chunk,
            safe_pad=safe_pad, packed_cap=cap,
        )
    return out


def sharded_search_flat(
    mesh,
    profs,
    qlens,
    sf: ShardedFlat,
    go: int,
    ge: int,
    algorithm: str,
    with_ends: bool = True,
    safe_pad: bool = False,
    m_abs: Optional[int] = None,
):
    """`sharded_search_flat_device` gathered into global target order.

    Pass ``safe_pad=True`` when the scoring matrix leaves profile column
    31 unused (every bundled matrix) for K1 on each shard; the default,
    the reference's, runs K4 or K5.  ``m_abs`` as in
    `sharded_search_flat_device`.  Returns ``(scores, q_ends,
    t_ends)`` numpy arrays of shape ``(n_q, n_targets)``, the same on
    every rank.
    """
    n_q = int(profs.shape[0])
    nblk_max = sf.lengths.shape[1]
    outs = sharded_search_flat_device(
        mesh, profs, qlens, sf, go, ge, algorithm, with_ends=with_ends,
        safe_pad=safe_pad, m_abs=m_abs,
    )
    # (n_shards, 3, n_q, nblk_max, lanes) -> (3, n_q, global target)
    stacked = _gather_host(mesh, {s: torch.stack(o) for s, o in outs.items()})
    flatpos = sf.inv_shard * (nblk_max * sf.lanes) + sf.inv_pos
    out = stacked.transpose(1, 2, 0, 3, 4).reshape(3, n_q, -1)[:, :, flatpos]
    return out[0], out[1], out[2]


def sharded_search_flat_q8(
    mesh,
    profs,
    qv,
    maxq,
    sf: ShardedFlat,
    go: int,
    ge: int,
    algorithm: str,
    with_ends: bool = True,
):
    """K2 (`q8.search_flat_q8`) once on each of this rank's shards,
    gathered into global target order.

    ``sf`` must be packed at the q8 lane width (512 for tiers up to 256,
    256 for tier 512); ``profs``/``qv``/``maxq`` come from
    `q8.make_profiles_q8_host`.  Returns ``(scores, q_ends, t_ends)``
    numpy arrays of shape ``(n_groups * QB, n_targets)``, row ``g * QB +
    qb`` holding group g's qb-th query slot, the same on every rank.
    """
    n_g = int(profs.shape[0])
    nblk_max = sf.lengths.shape[1]
    outs = {}
    for s, (flat_t, lengths, bos, cos, los) in _device_arrays(
        sf, mesh
    ).items():
        dev = mesh.devices[s]
        outs[s] = torch.stack(q8.search_flat_q8(
            _on(profs, dev), _on(qv, dev), _on(maxq, dev), flat_t, lengths,
            bos, cos, los, int(go), int(ge), algorithm, with_ends,
            chunk=sf.chunk,
        ))
    # (n_shards, 3, n_g, nblk_max, QB, lanes) -> (3, n_g * QB, target)
    stacked = _gather_host(mesh, outs)
    flatpos = sf.inv_shard * (nblk_max * sf.lanes) + sf.inv_pos
    out = stacked.transpose(1, 2, 4, 0, 3, 5).reshape(
        3, n_g * q8.QB, -1
    )[:, :, flatpos]
    return out[0], out[1], out[2]


def _gidx_device(sf: ShardedFlat, mesh):
    """Each local shard's global-index map on its device, cached on the
    pack per mesh.

    ``{shard: (nblk_max * lanes,) int32}``: entry ``p`` is the global
    target index packed at flat position ``p`` of the shard, or ``-1``
    for padding lanes and blocks.
    """
    cache = sf.__dict__.setdefault("_gidx_dev", {})
    hit = cache.get(mesh)
    if hit is None:
        nblk_max = sf.lengths.shape[1]
        gidx = np.full((sf.n_shards, nblk_max * sf.lanes), -1, np.int32)
        gidx[sf.inv_shard, sf.inv_pos] = np.arange(
            sf.n_targets, dtype=np.int32)
        hit = {s: torch.from_numpy(gidx[s]).to(mesh.devices[s])
               for s in local_shards_of_mesh(mesh)}
        cache.clear()  # one mesh at a time, as `_device_arrays`
        cache[mesh] = hit
    return hit


NEG_SENTINEL = -(2**31) + 1


def sharded_topk_candidates(mesh, outs, gidx, m: int):
    """Per-shard top-``m`` selection and the candidates' all-gather.

    ``outs``: `sharded_search_flat_device`'s ``{shard: (scores, q_ends,
    t_ends)}``, each ``(n_q, nblk, lanes)``; ``gidx``: the matching
    `_gidx_device` map.  Each shard selects its ``m`` best scores per
    query (padding positions masked to `NEG_SENTINEL`) with
    `torch.topk` on its device, and only those candidates, ``O(m *
    n_shards)`` values instead of ``O(n_targets)``, are gathered.
    Returns ``(values, global_indices, q_ends, t_ends)`` numpy arrays of
    shape ``(n_q, n_shards * m)``, shard ``s`` in columns ``[s * m, (s +
    1) * m)`` sorted by descending score; invalid slots carry
    `NEG_SENTINEL` / ``-1``.  The same on every rank.

    Selection within a shard is by score only (ties in any order): exact
    database-order tie-breaking happens in the host merge, which
    escalates ``m`` when a shard's candidate floor touches the global
    k-th score (`pyopal_tpu_torch.parallel.api.align_top_k_sharded`).
    """
    local = {}
    for s, (sc, qe, te) in outs.items():
        n_q = sc.shape[0]
        gi = gidx[s]
        mm = max(1, min(m, gi.shape[0]))
        fs = torch.where(gi[None] >= 0, sc.reshape(n_q, -1),
                         torch.tensor(NEG_SENTINEL, dtype=sc.dtype,
                                      device=sc.device))
        v, pos = torch.topk(fs, mm, dim=1, sorted=True)
        local[s] = torch.stack([
            v,
            gi[pos],  # padding slots carry -1 from gidx itself
            qe.reshape(n_q, -1).gather(1, pos),
            te.reshape(n_q, -1).gather(1, pos),
        ])
    # (n_shards, 4, n_q, mm) -> (4, n_q, n_shards * mm)
    stacked = _gather_host(mesh, local)
    out = stacked.transpose(1, 2, 0, 3).reshape(
        4, stacked.shape[2], -1)
    return out[0], out[1], out[2], out[3]
