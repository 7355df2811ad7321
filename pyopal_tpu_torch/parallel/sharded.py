"""Sharded group search and the global top-k merge.

Port of ``pyopal_tpu/parallel/sharded.py``:

- the blocks of one grouped-pack group (`pyopal_tpu_torch.ops.packing.
  pack_sequences`) are split into equal contiguous runs, one per shard;
- the query profile is copied to every shard's device (it is small:
  ``Q_pad x 32`` int32);
- each rank searches its own shards with the grouped kernel K6
  (`pyopal_tpu_torch.ops.group.search_group`; its plain version on a
  CPU mesh): no communication while they run;
- the per-shard score/end arrays are all-gathered (a few bytes per
  target), so every rank holds the group's results in block order.

`top_k_merge` selects the best hits per shard and merges only those
candidates across ranks: ``O(k * n_shards)`` values travel, not the
whole score array.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import group
from .sharded_flat import _gather_host, _on, local_shards_of_mesh


def pad_blocks(targets: np.ndarray, lengths: np.ndarray, n_devices: int):
    """Pad the block axis to a multiple of ``n_devices``.

    Padding blocks have length 0 in every lane, so they contribute no
    results (their packed indices are absent).
    """
    nblk = targets.shape[0]
    pad = (-nblk) % n_devices
    if pad:
        targets = np.concatenate(
            [targets, np.zeros((pad,) + targets.shape[1:], targets.dtype)]
        )
        lengths = np.concatenate(
            [lengths, np.zeros((pad,) + lengths.shape[1:], lengths.dtype)]
        )
    return targets, lengths


def _shard_runs(mesh, n):
    """This rank's shards with their ``[start, stop)`` run of ``n`` rows;
    ``n`` must split evenly over the mesh."""
    if n % mesh.n_shards:
        raise ValueError(
            f"{n} rows do not split evenly over {mesh.n_shards} shards "
            "(see pad_blocks)"
        )
    per = n // mesh.n_shards
    return [(s, s * per, (s + 1) * per) for s in local_shards_of_mesh(mesh)]


def sharded_search_group(
    mesh,
    prof,
    targets,
    lengths,
    go: int,
    ge: int,
    algorithm: str,
    with_ends: bool = True,
):
    """Search one packed group with its blocks sharded over ``mesh``.

    ``prof``: the ``(profile, Q)`` pair of `group.make_profile_host`;
    ``targets``: ``(n_blocks, t_pad, lanes)`` symbols (numpy, or tensors
    on any device; uint8 or int32) with ``n_blocks`` a multiple of the
    mesh size (see `pad_blocks`); ``lengths``: ``(n_blocks, lanes)``
    int32.  Each shard runs `group.search_group`: K6 on a CUDA mesh, its
    plain version on a CPU mesh.  The reference's second route, the
    sweep per block (``use_pallas=False``), exists because interpreted
    Pallas is slow off the TPU and is not ported.

    Returns ``(scores, query_ends, target_ends)`` numpy arrays of shape
    ``(n_blocks, lanes)``, the same on every rank.
    """
    prof_arr, Q = prof
    outs = {}
    for s, b0, b1 in _shard_runs(mesh, targets.shape[0]):
        dev = mesh.devices[s]
        out = group.search_group(
            (_on(prof_arr, dev), Q), _on(targets[b0:b1], dev),
            _on(lengths[b0:b1], dev), go, ge, algorithm, with_ends,
        )
        outs[s] = torch.stack(list(out))
    # (n_shards, 3, blocks per shard, lanes) -> 3 x (n_blocks, lanes)
    stacked = _gather_host(mesh, outs)
    planes = stacked.transpose(1, 0, 2, 3).reshape(3, -1, stacked.shape[-1])
    return planes[0], planes[1], planes[2]


def top_k_merge(mesh, scores, indices, k: int):
    """Global top-k hits from per-target scores split over the shards.

    ``scores``/``indices``: ``(n,)`` arrays (numpy or tensors), shard
    ``s`` holding the ``s``-th of ``n_shards`` equal contiguous runs.
    Each shard selects its ``k`` best on its device, the candidates are
    all-gathered (``O(k * n_shards)`` values), and the merge selects the
    ``k`` best of those.  Selection is by descending score with ties to
    the lower position, as ``lax.top_k`` orders them, so the result is
    that of a stable sort of the whole array.

    Returns ``(values, indices)`` numpy arrays of ``min(k, n)`` entries
    in the types of ``scores`` and ``indices``, the same on every rank.
    """
    cands = {}
    for s, i0, i1 in _shard_runs(mesh, len(scores)):
        dev = mesh.devices[s]
        v = _on(scores[i0:i1], dev)
        order = torch.sort(v, descending=True, stable=True).indices[:k]
        cands[s] = torch.stack([v[order].long(),
                                _on(indices[i0:i1], dev)[order].long()])
    gathered = _gather_host(mesh, cands)  # (n_shards, 2, min(k, run))
    v = gathered[:, 0].reshape(-1)
    top = np.argsort(-v, kind="stable")[:k]
    types = (_on(x[:0], "cpu").numpy().dtype for x in (scores, indices))
    return tuple(
        gathered[:, i].reshape(-1)[top].astype(t) for i, t in enumerate(types)
    )
