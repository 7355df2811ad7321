"""The card's ceilings and the arithmetic of rates and rooflines.

The ceiling of a dynamic-programming kernel is one fixed number for
every kernel, counted on the cells the inputs need (query residues x
target residues, unpadded), so that it reads the same work whatever
kernel does it:

- the cheapest cell update the port holds is K7's packed form, 5.5
  s16x2 instructions for two cells: 2.75 instructions a cell
  (``csrc/q8_narrow.cu``; PERF.md, kernel table);
- at the H100's published int32 issue rate of 64 a streaming
  multiprocessor a clock (NVIDIA H100 Tensor Core GPU Architecture
  whitepaper: 16 INT32 units in each of an SM's four partitions), on
  132 SMs (H100 SXM5) at the 1,980 MHz boost clock;
- 132 x 64 x 1.98e9 / 2.75 = 6.08e12 cells a second.

The byte bound reads the database once a call at 3.35 TB/s, the
published HBM3 bandwidth of the H100 SXM5.  Both assume the card's full
700 W power limit.
"""

from __future__ import annotations

SMS = 132
INT32_PER_SM_CLOCK = 64
CLOCK_HZ = 1.98e9
INSTRUCTIONS_PER_CELL = 2.75
CELLS_PER_S = SMS * INT32_PER_SM_CLOCK * CLOCK_HZ / INSTRUCTIONS_PER_CELL
HBM_BYTES_PER_S = 3.35e12


def gcups(cells: int, seconds: float) -> float:
    """Giga cell updates a second."""
    return cells / seconds / 1e9


def bound_seconds(cells: int, db_bytes: int) -> float:
    """The least time the card could take for ``cells`` cell updates
    that read ``db_bytes`` of database: the larger of the two bounds."""
    return max(cells / CELLS_PER_S, db_bytes / HBM_BYTES_PER_S)


def roofline_pct(cells: int, db_bytes: int, kernel_seconds: float):
    """The bound as a share of the kernels' device time, in percent;
    None where no kernel ran."""
    if kernel_seconds <= 0:
        return None
    return 100.0 * bound_seconds(cells, db_bytes) / kernel_seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of all values, by linear
    interpolation between the two nearest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
