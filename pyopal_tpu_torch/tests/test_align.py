"""In-wheel `pyopal_tpu_torch.align` front-end tests.

Port of ``pyopal_tpu/tests/test_align.py``, after upstream PyOpal's
threaded front-end contract (``src/pyopal/tests/test_align.py``): the
chunked multi-worker path must be result-identical to the single-worker
path, with the upstream golden scores.
"""

import unittest

import pyopal_tpu_torch

from ._devices import devices


class TestAlign(unittest.TestCase):
    QUERY = "ACCTCG"
    TARGETS = ["AACCGCTG", "AACCGCTA", "AACCGCTC", "AACCGCTT"]

    def _golden(self, threads):
        for device in devices():
            with self.subTest(device=device):
                results = list(
                    pyopal_tpu_torch.align(
                        self.QUERY,
                        self.TARGETS,
                        threads=threads,
                        mode="full",
                        algorithm="nw",
                        ordered=True,
                        device=device,
                    )
                )
                first = results[0]
                self.assertEqual(first.target_index, 0)
                self.assertEqual(first.score, 44)
                self.assertEqual((first.query_end, first.target_end), (5, 7))
                self.assertEqual(
                    (first.query_start, first.target_start), (0, 0)
                )

    def test_threads_1(self):
        self._golden(threads=1)

    def test_threads_2(self):
        self._golden(threads=2)

    def test_doctest_scores(self):
        targets = ["AACCGCTG", "ATGCGCT", "TTATTACG"]
        for device in devices():
            with self.subTest(device=device):
                scores = [
                    res.score
                    for res in pyopal_tpu_torch.align(
                        "ACCTG", targets, gap_open=2, ordered=True,
                        device=device,
                    )
                ]
                self.assertEqual(scores, [41, 31, 23])
