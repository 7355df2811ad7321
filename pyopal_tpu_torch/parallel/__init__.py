"""Multi-device and multi-process database sharding.

Port of ``pyopal_tpu/parallel``: the encoded database is sharded over a
`Mesh` of devices (several cards, one card, or the CPU) and of the ranks
of a `torch.distributed` group, query profiles are copied to every
shard, and per-shard results are merged with ``all_gather``.

On the CPU (``device="cpu"``) the shards run the kernels' plain
versions; a group of processes there uses ``gloo``.  On one card a
mesh of several shards runs them one after another, and two ranks may
share the card under ``gloo``; across cards, ``nccl`` with one rank per
card.
"""

from .api import align_arrays_sharded, align_top_k_sharded
from .mesh import DB_AXIS, Mesh, device_mesh, initialize_distributed
from .sharded_flat import (
    ShardedFlat,
    local_shards_of_mesh,
    pack_flat_sharded,
    sharded_search_flat,
)

__all__ = [
    "align_arrays_sharded",
    "align_top_k_sharded",
    "DB_AXIS",
    "device_mesh",
    "initialize_distributed",
    "ShardedFlat",
    "local_shards_of_mesh",
    "pack_flat_sharded",
    "sharded_search_flat",
]
