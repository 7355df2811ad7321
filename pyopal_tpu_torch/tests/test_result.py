"""In-wheel result-class tests: port of ``pyopal_tpu/tests/test_result.py``
(upstream PyOpal ``tests/test_result.py``)."""

import pickle
import unittest

from pyopal_tpu_torch import EndResult, FullResult, ScoreResult


class TestScoreResult(unittest.TestCase):
    def test_roundtrip(self):
        r = ScoreResult(10, score=30)
        self.assertEqual((r.target_index, r.score), (10, 30))
        self.assertEqual(repr(r), "ScoreResult(10, score=30)")
        r2 = pickle.loads(pickle.dumps(r))
        self.assertEqual(r, r2)
        self.assertNotEqual(r, ScoreResult(12, score=50))
        self.assertNotEqual(r, 12)


class TestEndResult(unittest.TestCase):
    def test_roundtrip(self):
        r = EndResult(2, score=30, query_end=10, target_end=20)
        self.assertEqual(
            (r.target_index, r.score, r.query_end, r.target_end),
            (2, 30, 10, 20),
        )
        self.assertEqual(
            repr(r),
            "EndResult(2, score=30, query_end=10, target_end=20)",
        )
        self.assertEqual(r, pickle.loads(pickle.dumps(r)))


class TestFullResult(unittest.TestCase):
    def test_derived_stats(self):
        # the reference's doctest alignment (NW ACCTCG vs AACCGCTG):
        # cigar folds X into M runs
        r = FullResult(
            target_index=0,
            score=44,
            query_end=5,
            target_end=7,
            query_start=0,
            target_start=0,
            query_length=6,
            target_length=8,
            alignment="IMMMXMIM",
        )
        self.assertEqual(r.cigar(), "1D5M1D1M")
        self.assertAlmostEqual(r.identity(), 5 / 6, places=6)
        self.assertEqual(r.coverage("query"), 1.0)
        self.assertEqual(r.coverage("target"), 7 / 8)
        self.assertEqual(r, pickle.loads(pickle.dumps(r)))


class TestConstruction(unittest.TestCase):
    """The C types' argument handling (``native/results.c``), which the
    pure-Python fallback classes repeat."""

    def test_negative_index_and_ranges(self):
        self.assertEqual(ScoreResult(-1, 5).target_index, -1)
        self.assertEqual(
            repr(EndResult(-1, 5, 0, 0)),
            "EndResult(-1, score=5, query_end=0, target_end=0)",
        )
        with self.assertRaisesRegex(OverflowError, "C ssize_t"):
            ScoreResult(2**63, 5)
        with self.assertRaisesRegex(OverflowError, "C long"):
            ScoreResult(1, 2**63)

    def test_argument_errors(self):
        with self.assertRaisesRegex(TypeError, "cannot be interpreted"):
            ScoreResult(1, 5.0)
        with self.assertRaisesRegex(
            TypeError, r"missing required argument 'target_index' \(pos 1\)"
        ):
            ScoreResult()
        with self.assertRaisesRegex(TypeError, r"at most 2 arguments \(3"):
            ScoreResult(1, 5, 6)
