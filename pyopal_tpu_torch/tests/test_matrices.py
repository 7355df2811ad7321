"""In-wheel matrix catalog tests (port of ``pyopal_tpu/tests/test_matrices.py``)."""

import unittest

import numpy as np

from pyopal_tpu_torch import ScoringMatrix


class TestCatalog(unittest.TestCase):
    def test_all_bundled_are_valid(self):
        names = ScoringMatrix.available_matrices()
        # the full BLOSUM clustering series + PAM anchors + VTML80
        for expected in (
            "BLOSUM30", "BLOSUM45", "BLOSUM50", "BLOSUM62", "BLOSUM80",
            "BLOSUM100", "PAM250", "VTML80",
        ):
            self.assertIn(expected, names)
        for name in names:
            m = ScoringMatrix.from_name(name)
            self.assertEqual(m.size(), len(m.alphabet))
            self.assertTrue(m.is_integer(), name)
            self.assertTrue(m.is_symmetric(), name)

    def test_blosum50_golden_entries(self):
        m = ScoringMatrix.from_name("BLOSUM50")
        a = m.alphabet
        get = lambda x, y: m.data[a.index(x), a.index(y)]
        self.assertEqual(get("A", "A"), 5)
        self.assertEqual(get("C", "C"), 13)
        self.assertEqual(get("W", "W"), 15)

    def test_pam_family_regenerates_anchor(self):
        self.assertEqual(
            ScoringMatrix.pam(250), ScoringMatrix.from_name("PAM250")
        )

    def test_vtml_family_regenerates_anchor(self):
        self.assertEqual(
            ScoringMatrix.vtml(80), ScoringMatrix.from_name("VTML80")
        )
        # generated distances are integer, symmetric, right-sized
        m = ScoringMatrix.from_name("VTML160")
        self.assertTrue(m.is_integer())
        self.assertTrue(m.is_symmetric())
        self.assertEqual(m.size(), len(m.alphabet))

    def test_unknown_name(self):
        with self.assertRaises(ValueError):
            ScoringMatrix.from_name("NOPE99")
