"""Tests shipped inside the package, runnable post-install.

Port of the JAX package's in-wheel suite (``pyopal_tpu/tests``), which
mirrors upstream PyOpal's (``src/pyopal/tests/__init__.py:13-20``, run
as ``python -m unittest pyopal.tests``)::

    python -m unittest pyopal_tpu_torch.tests

Coverage on an installed artifact: golden answers (the upstream suite's
pinned numbers), container and alphabet semantics, result classes, the
threaded front-end, the matrix catalog, every public module's docstring
examples, and the kernels' plain versions against the scalar oracle.
Every case that searches runs on the CPU (``device="cpu"``) and, where
PyTorch sees a CUDA card, on ``"cuda"`` too, as subtests of the same
test.  The full development suite (comparisons with the JAX package,
the sharded path, the card-only tests) lives in the repository's
``tests/`` directory.
"""

import unittest

from . import (
    test_align,
    test_alphabet,
    test_database,
    test_doctest,
    test_engine,
    test_matrices,
    test_result,
    test_smoke,
)

_MODULES = [
    test_smoke,
    test_align,
    test_alphabet,
    test_database,
    test_doctest,
    test_engine,
    test_matrices,
    test_result,
]


def load_tests(loader, suite, pattern):
    for module in _MODULES:
        suite.addTests(loader.loadTestsFromModule(module))
    return suite
