"""Alignment algorithm definitions (the framework's "models").

Port of ``pyopal_tpu/models/__init__.py``.

The reference exposes four affine-gap DP algorithms through a single
native entry point (``opalSearchDatabase`` mode constants,
upstream PyOpal ``src/pyopal/opal.pxd:9-12``).  Here each algorithm is a
declarative `AlgorithmSpec` — boundary conditions + where the optimal
score is read — consumed uniformly by every engine (naive oracle,
vectorized XLA engine, Pallas TPU kernel), so semi-global boundary
subtleties live in exactly one place.
"""

from .specs import ALGORITHMS, AlgorithmSpec

__all__ = ["ALGORITHMS", "AlgorithmSpec"]
