"""Run docstring examples of every public submodule as tests.

Port of ``pyopal_tpu/tests/test_doctest.py``, the in-wheel mirror of
upstream PyOpal's shipped doctest walker
(``src/pyopal/tests/test_doctest.py``): the documented examples
(``Database.extend``, ``FullResult.cigar``, the ``align`` generator, ...)
double as API-stability checks on an installed artifact.  The examples
that search pass ``device="cpu"``.
"""

import doctest
import importlib
import unittest

import pyopal_tpu_torch

MODULES = [
    "pyopal_tpu_torch",
    "pyopal_tpu_torch._align",
    "pyopal_tpu_torch.alphabet",
    "pyopal_tpu_torch.aligner",
    "pyopal_tpu_torch.database",
    "pyopal_tpu_torch.matrices",
    "pyopal_tpu_torch.results",
    "pyopal_tpu_torch.io",
    "pyopal_tpu_torch.parallel.api",
]


class TestDoctests(unittest.TestCase):
    pass


def _make_case(name):
    def _case(self):
        module = importlib.import_module(name)
        globs = dict(module.__dict__)
        # examples reference public names unqualified, like the
        # upstream doctests do (its test_doctest.py injects the
        # package into the example globals)
        globs.update(
            {
                "pyopal_tpu_torch": pyopal_tpu_torch,
                "Aligner": pyopal_tpu_torch.Aligner,
                "Alphabet": pyopal_tpu_torch.Alphabet,
                "Database": pyopal_tpu_torch.Database,
                "ScoringMatrix": pyopal_tpu_torch.ScoringMatrix,
                "align": pyopal_tpu_torch.align,
            }
        )
        runner = doctest.DocTestRunner(
            verbose=False,
            optionflags=doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE,
        )
        finder = doctest.DocTestFinder(exclude_empty=True)
        failures = tries = 0
        for test in finder.find(module, name, globs=globs):
            result = runner.run(test)
            failures += result.failed
            tries += result.attempted
        self.assertEqual(
            failures, 0, f"{failures} doctest failure(s) in {name}"
        )

    return _case


for _name in MODULES:
    setattr(
        TestDoctests,
        "test_" + _name.replace(".", "_"),
        _make_case(_name),
    )
del _name
