"""Run the port's in-wheel test package as part of the development
suite.

The wheel ships `pyopal_tpu_torch.tests` (run post-install as
``python -m unittest pyopal_tpu_torch.tests``, as the JAX package ships
`pyopal_tpu.tests`); collecting its TestCases here keeps the shipped
suite from rotting between releases.
"""

from pyopal_tpu_torch.tests.test_align import TestAlign
from pyopal_tpu_torch.tests.test_alphabet import TestAlphabet
from pyopal_tpu_torch.tests.test_database import TestDatabase
from pyopal_tpu_torch.tests.test_doctest import TestDoctests
from pyopal_tpu_torch.tests.test_engine import TestEngineOracle
from pyopal_tpu_torch.tests.test_matrices import TestCatalog
from pyopal_tpu_torch.tests.test_result import (
    TestConstruction,
    TestEndResult,
    TestFullResult,
    TestScoreResult,
)
from pyopal_tpu_torch.tests.test_smoke import TestContainers, TestGolden
import _torch_cpu  # noqa: F401  (torch threads: a worker's share)

__all__ = [
    "TestAlign",
    "TestAlphabet",
    "TestDatabase",
    "TestDoctests",
    "TestEngineOracle",
    "TestCatalog",
    "TestConstruction",
    "TestEndResult",
    "TestFullResult",
    "TestScoreResult",
    "TestContainers",
    "TestGolden",
]
