"""Shard meshes for sharded database search.

Port of ``pyopal_tpu/parallel/mesh.py``.  The reference's parallel axis
is a 1-D JAX device mesh with one ``"db"`` axis; here a `Mesh` is a list
of database shards, each owned by one rank of a `torch.distributed`
group and placed on one `torch.device` of that rank.  Shards of one rank
are contiguous, as JAX orders a mesh's devices by process, and several
shards may share a device: one process can run a 4-shard mesh on one
card or on the CPU.  Per-shard outputs meet on every rank through
``all_gather`` (`pyopal_tpu_torch.parallel.sharded_flat._gather_host`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

DB_AXIS = "db"


def initialize_distributed(
    backend: str | None = None,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
) -> None:
    """Join the process group that spans the ranks of a sharded search.

    A thin `torch.distributed.init_process_group`: ``backend`` defaults
    to ``"nccl"`` where CUDA is available and ``"gloo"`` elsewhere (two
    ranks sharing one card need ``"gloo"``: NCCL refuses them);
    ``init_method`` defaults to ``env://`` (``MASTER_ADDR`` /
    ``MASTER_PORT``); a ``file://`` path or ``tcp://host:port`` also
    serve.  After this, `device_mesh` deals shards over every rank, each
    rank packs and searches only its own shards, and the outputs are
    all-gathered: the multi-process analog of the reference's thread-pool
    chunking, with the same invariant that chunking never changes scores
    and target indices stay global.

    Call once per process.  No-op if the group is already initialized.
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {"backend": backend}
    if init_method is not None:
        kwargs["init_method"] = init_method
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(**kwargs)


@dataclass(frozen=True)
class Mesh:
    """Database shards over the ranks of a process group.

    Shard ``s`` belongs to rank ``ranks[s]`` and lies on ``devices[s]``
    (a device of that rank; the entries of other ranks say where they
    placed theirs).  ``rank`` is this process's rank.
    """

    devices: tuple
    ranks: tuple
    rank: int = 0

    @property
    def n_shards(self) -> int:
        return len(self.ranks)

    @property
    def shape(self) -> dict:
        """``{"db": n_shards}``, as the reference's mesh reports it."""
        return {DB_AXIS: self.n_shards}

    @property
    def platform(self) -> str:
        """``"cuda"`` or ``"cpu"``: the type of the shards' devices."""
        return self.devices[0].type


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def device_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """A mesh of ``n_devices`` shards dealt over the group's ranks.

    ``device`` (``None`` means ``"cuda"``, which must be available) is
    where this rank's shards lie.  ``"cuda"`` without an index spreads a
    single process's shards over its cards in turn (several shards per
    card when there are more shards than cards) and puts each rank of a
    group on card ``rank % device_count``; ``"cuda:1"`` or ``"cpu"``
    puts every shard of this rank there.  ``n_devices`` defaults to one
    shard per card in a single process and one per rank in a group; it
    must be a multiple of the group's size.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the "
            "kernels' plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {dev}")
    world, rank = _world()
    cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n_devices is None:
        n_devices = cards if world == 1 and dev.index is None else world
    if n_devices < 1 or n_devices % world:
        raise ValueError(
            f"requested {n_devices} shards, which {world} ranks cannot "
            "share equally"
        )
    per_rank = n_devices // world

    def place(s):
        if dev.type == "cpu" or dev.index is not None:
            return dev
        card = s if world == 1 else s // per_rank
        return torch.device("cuda", card % cards)

    return Mesh(
        tuple(place(s) for s in range(n_devices)),
        tuple(s // per_rank for s in range(n_devices)),
        rank,
    )
