"""Packed database layouts read by the port's kernels.

Port of ``pyopal_tpu/ops/packing.py``, numpy only, in two halves:

- the flat layout (`flat_layout`, `fill_flat_payload`,
  `pack_sequences_flat`, `pack_database_slice_flat`) of K1-K3: targets
  are sorted by length and cut into blocks of ``lanes`` targets (one
  target per lane); every block is padded to a multiple of ``chunk``
  columns with pad symbol 31, and the blocks concatenate into one
  ``(total_rows, lanes)`` uint8 array.  Per-step maps (``block_of_step``
  / ``chunk_of_step`` / ``last_of_step``) and the inverse permutation
  ``inv_pos`` are identical to the reference's;
- the grouped layout (`pack_sequences`, `pack_database_slice`) of K6:
  the same length-sorted blocks, each padded to a quantized length
  (`_quantize_length`) with pad symbol 0, and blocks of one padded
  length stacked into one `PackedGroup`.

Both are byte-equal to the reference's, so both packages' kernels read
the same arrays and results compare target by target.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import threading

import numpy as np

#: Number of database sequences per block (one per lane).
LANES = 128

#: Column padding quantum of the grouped layout.
COL_QUANTUM = 16


def _quantize_length(n: int) -> int:
    """Round ``n`` up to a grouped block's padded length.

    Multiples of 32 up to 256, then multiples of 256 (the reference
    kernel's column chunk): padding waste stays near 12% for long
    targets while the set of padded lengths stays small.
    """
    n = max(n, COL_QUANTUM)
    if n <= 256:
        return -(-n // 32) * 32
    return -(-n // 256) * 256


@dataclass
class PackedGroup:
    """All blocks sharing one padded target length.

    Attributes:
        targets: ``(n_blocks, t_pad, LANES)`` uint8 encoded symbols
            (padding symbol is 0, masked out by per-lane lengths).
        lengths: ``(n_blocks, LANES)`` int32 true target lengths
            (0 for padding lanes).
        indices: ``(n_blocks, LANES)`` int32 global target indices
            (-1 for padding lanes).
    """

    t_pad: int
    targets: np.ndarray
    lengths: np.ndarray
    indices: np.ndarray


@dataclass
class PackedDatabase:
    """A database slice packed into padded blocks."""

    n_targets: int
    groups: List[PackedGroup] = field(default_factory=list)

    @property
    def total_cells_padded(self) -> int:
        return sum(int(g.targets.size) for g in self.groups)

    @property
    def total_cells(self) -> int:
        return int(sum(int(g.lengths.sum()) for g in self.groups))


def pack_sequences(sequences, lanes: int = LANES) -> PackedDatabase:
    """Pack encoded sequences (list of uint8 arrays) into grouped blocks.

    Targets are sorted by length, grouped into blocks of ``lanes``, each
    block padded to the quantized maximum length of its members, and
    blocks of identical padded length are stacked.
    """
    n = len(sequences)
    packed = PackedDatabase(n_targets=n)
    if n == 0:
        return packed

    order = sorted(range(n), key=lambda i: len(sequences[i]))
    by_tpad: Dict[int, list] = {}

    for start in range(0, n, lanes):
        chunk = order[start : start + lanes]
        max_len = max(len(sequences[i]) for i in chunk)
        t_pad = _quantize_length(max_len)
        tgt = np.zeros((t_pad, lanes), dtype=np.uint8)
        lens = np.zeros(lanes, dtype=np.int32)
        idx = np.full(lanes, -1, dtype=np.int32)
        for lane, i in enumerate(chunk):
            seq = sequences[i]
            tgt[: seq.shape[0], lane] = seq
            lens[lane] = seq.shape[0]
            idx[lane] = i
        by_tpad.setdefault(t_pad, []).append((tgt, lens, idx))

    for t_pad in sorted(by_tpad):
        blocks = by_tpad[t_pad]
        packed.groups.append(
            PackedGroup(
                t_pad=t_pad,
                targets=np.stack([b[0] for b in blocks]),
                lengths=np.stack([b[1] for b in blocks]),
                indices=np.stack([b[2] for b in blocks]),
            )
        )
    return packed

@dataclass
class FlatPacked:
    """Flat single-launch layout for the ragged kernel.

    All blocks concatenate along the column axis into one
    ``(total_rows, LANES)`` array whose row count is a multiple of the
    kernel column chunk; per-step scalar maps tell the kernel which
    block each chunk belongs to (see
    `pyopal_tpu_torch.ops.ragged`).
    """

    n_targets: int
    n_blocks: int
    flat_targets: np.ndarray  # (total_rows, LANES) uint8 symbols
    lengths: np.ndarray  # (n_blocks, 1, LANES) int32
    indices: np.ndarray  # (n_blocks, LANES) int32, -1 = padding lane
    block_of_step: np.ndarray  # (n_steps,) int32
    chunk_of_step: np.ndarray  # (n_steps,) int32
    last_of_step: np.ndarray  # (n_steps,) int32
    inv_pos: np.ndarray  # (n_targets,) int32: target i -> block*LANES+lane
    chunk: int = 64  # column-chunk quantum of this layout

    @property
    def total_cells_padded(self) -> int:
        # .size covers non-default lane widths (q8 packs use 256/512)
        return int(self.flat_targets.size)

    @property
    def total_cells(self) -> int:
        return int(self.lengths.sum())


@dataclass
class FlatLayout:
    """The metadata half of a `FlatPacked`: everything derivable from
    the *lengths* alone (block assignment, padded shapes, step maps,
    index permutations) without touching sequence payloads.

    Splitting layout from fill lets a multi-host pack compute the
    global plan everywhere (it is O(n) small) while each process fills
    payload arrays only for its own shards
    (``pyopal_tpu.parallel.sharded_flat`` in the reference package).
    """

    n_targets: int
    n_blocks: int
    total_rows: int
    blocks: list  # per block: list of target indices (lane order)
    t_pads: list  # per block: padded row count
    lengths: np.ndarray  # (n_blocks, 1, lanes) int32
    indices: np.ndarray  # (n_blocks, lanes) int32, -1 = padding lane
    block_of_step: np.ndarray
    chunk_of_step: np.ndarray
    last_of_step: np.ndarray
    inv_pos: np.ndarray
    lanes: int
    chunk: int


def flat_layout(
    seq_lengths, lanes: int = LANES, chunk: int = 64
) -> FlatLayout:
    """Compute the flat layout for targets of the given lengths."""
    n = len(seq_lengths)
    if n == 0:
        z = np.zeros(0, np.int32)
        return FlatLayout(
            0, 0, 0, [], [],
            np.zeros((0, 1, lanes), np.int32),
            np.zeros((0, lanes), np.int32),
            z, z, z, z, lanes, chunk,
        )

    order = sorted(range(n), key=lambda i: seq_lengths[i])
    blocks = [order[s : s + lanes] for s in range(0, n, lanes)]
    n_blocks = len(blocks)

    t_pads = []
    for chunk_ids in blocks:
        max_len = max(seq_lengths[i] for i in chunk_ids)
        t_pads.append(-(-max(max_len, 1) // chunk) * chunk)
    total_rows = sum(t_pads)

    lengths = np.zeros((n_blocks, 1, lanes), dtype=np.int32)
    indices = np.full((n_blocks, lanes), -1, dtype=np.int32)
    bos, cos, los = [], [], []
    for b, chunk_ids in enumerate(blocks):
        for lane, i in enumerate(chunk_ids):
            lengths[b, 0, lane] = seq_lengths[i]
            indices[b, lane] = i
        n_chunks = t_pads[b] // chunk
        for ci in range(n_chunks):
            bos.append(b)
            cos.append(ci)
            los.append(1 if ci == n_chunks - 1 else 0)

    inv_pos = np.zeros(n, dtype=np.int32)
    flat_idx = indices.reshape(-1)
    valid = flat_idx >= 0
    inv_pos[flat_idx[valid]] = np.nonzero(valid)[0].astype(np.int32)

    return FlatLayout(
        n,
        n_blocks,
        total_rows,
        blocks,
        t_pads,
        lengths,
        indices,
        np.asarray(bos, np.int32),
        np.asarray(cos, np.int32),
        np.asarray(los, np.int32),
        inv_pos,
        lanes,
        chunk,
    )


def fill_flat_payload(
    layout: FlatLayout, sequences, dtype=np.uint8
) -> np.ndarray:
    """Build the ``(total_rows, lanes)`` symbol array for a layout.

    The payload is uint8 — encoded symbols occupy 5 bits — so a
    packed database costs one byte per residue on the host and on the
    device.  Padding is symbol 31 (the reference's kernels score it
    ``PAD_SCORE``; the port's kernels stop at each lane's length and
    never read it).
    """
    flat = np.full((layout.total_rows, layout.lanes), 31, dtype=dtype)
    row = 0
    for b, chunk_ids in enumerate(layout.blocks):
        for lane, i in enumerate(chunk_ids):
            seq = sequences[i]
            flat[row : row + seq.shape[0], lane] = seq
        row += layout.t_pads[b]
    return flat


def pack_sequences_flat(
    sequences, lanes: int = LANES, chunk: int = 64
) -> FlatPacked:
    """Pack encoded sequences into the flat ragged-kernel layout."""
    layout = flat_layout([len(s) for s in sequences], lanes, chunk)
    flat = fill_flat_payload(layout, sequences)
    return FlatPacked(
        layout.n_targets,
        layout.n_blocks,
        flat,
        layout.lengths,
        layout.indices,
        layout.block_of_step,
        layout.chunk_of_step,
        layout.last_of_step,
        layout.inv_pos,
        chunk,
    )



#: per-database cap on memoized packs: each entry pins host arrays and
#: (via the ``_dev`` cache) device copies, so sliding-window query
#: patterns must not grow the cache without bound.  Eviction is FIFO;
#: the cache is also cleared wholesale on every database mutation.
PACK_CACHE_MAX = 16


_CACHE_LOCK = threading.Lock()


def _cache_put(cache, key, value):
    if cache is None:
        return
    # concurrent ThreadPool workers (align(threads>=2)) insert under
    # the shared read lock; serialize the FIFO eviction so two racing
    # misses cannot pop the same key
    with _CACHE_LOCK:
        while len(cache) >= PACK_CACHE_MAX:
            try:
                cache.pop(next(iter(cache)))
            except (StopIteration, KeyError):  # pragma: no cover
                break
        cache[key] = value


def pack_database_slice_flat(
    database, start: int, end: int, lanes: int = LANES
) -> FlatPacked:
    """Flat-pack ``database[start:end]`` (caller holds the read lock).

    ``lanes`` selects the block width: 128 for the row-vectorized
    ragged kernels, wider (256/512) for the query-packed q8 kernel,
    whose lane widths the reference picked per query tier (see
    `pyopal_tpu_torch.ops.q8`).
    """
    cache = getattr(database, "_pack_cache", None)
    key = ("flat", lanes, database.get_version(), start, end)
    # .get, not `in`+[]: a concurrent _cache_put FIFO eviction between
    # the two would raise KeyError on a hit
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            return hit
    seqs = [database.get_encoded(i) for i in range(start, end)]
    packed = pack_sequences_flat(seqs, lanes=lanes)
    _cache_put(cache, key, packed)
    return packed


def pack_database_slice(database, start: int, end: int) -> PackedDatabase:
    """Grouped pack of ``database[start:end]`` (caller holds the read
    lock), memoized like `pack_database_slice_flat`."""
    cache = getattr(database, "_pack_cache", None)
    key = (database.get_version(), start, end)
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            return hit
    seqs = [database.get_encoded(i) for i in range(start, end)]
    packed = pack_sequences(seqs)
    _cache_put(cache, key, packed)
    return packed
