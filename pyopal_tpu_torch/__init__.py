"""pyopal_tpu_torch — the PyTorch and CUDA port of `pyopal_tpu`.

A database-search aligner with the capabilities of PyOpal/Opal: one
query (or a batch) scored against every sequence of a database with four
affine-gap DP algorithms — Smith-Waterman local (``sw``),
Needleman-Wunsch global (``nw``) and two semi-global variants (``hw``,
``ov``) — in score, score+end and full-alignment (CIGAR) modes.  Port
of ``pyopal_tpu/__init__.py`` with the same public names.

The searches run on an NVIDIA GPU through hand-written CUDA kernels
(``csrc/ragged.cu``, ``csrc/q8.cu`` and, for queries beyond 4096
residues that a single launch cannot take, the segmented
``csrc/ragged_long.cu``; full mode adds the traceback's direction pass
``csrc/traceback_dirs.cu`` and walk ``csrc/traceback_walk.cu``), built
with ``nvcc`` at first use.  The host side's hot loops (sequence
encoding, FASTA parsing, wrapping results) run in the C extensions of
`pyopal_tpu_torch.native`, compiled at first import.
``device="cpu"`` runs the same dispatch with the kernels' plain PyTorch
versions instead.  `pyopal_tpu_torch.parallel` shards one search over
several cards, one card, or the ranks of a `torch.distributed` group
(with the grouped kernel ``csrc/group.cu`` for its group search).  The
package imports PyTorch and numpy only.

Example:
    >>> import pyopal_tpu_torch
    >>> targets = ["AACCGCTG", "ATGCGCT", "TTATTACG"]
    >>> hits = pyopal_tpu_torch.align(
    ...     "ACCTG", targets, gap_open=2, ordered=True, device="cpu"
    ... )
    >>> for res in hits:
    ...     print(res.score, targets[res.target_index])
    41 AACCGCTG
    31 ATGCGCT
    23 TTATTACG

"""

__version__ = "0.5.1"
__all__ = [
    "Alphabet",
    "Aligner",
    "AlignFuture",
    "BaseDatabase",
    "Database",
    "ScoreResult",
    "EndResult",
    "FullResult",
    "ScoringMatrix",
    "align",
    "read_fasta",
    "save_database",
    "load_database",
    "__version__",
]

# Bootstrap the native extensions before the submodules that bind them
# (compiled at first import; an installed wheel may ship them prebuilt;
# pure-Python fallbacks cover failure).
from . import native as _native

_native.ensure_built()

from ._align import align
from .aligner import Aligner, AlignFuture
from .alphabet import Alphabet
from .database import BaseDatabase, Database
from .io import load_database, read_fasta, save_database
from .matrices import ScoringMatrix
from .results import EndResult, FullResult, ScoreResult
from .utils.deviceinfo import _device_info
