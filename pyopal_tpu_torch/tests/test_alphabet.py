"""In-wheel `Alphabet` tests: port of ``pyopal_tpu/tests/test_alphabet.py``
(upstream PyOpal ``tests/test_alphabet.py``)."""

import pickle
import unittest

from pyopal_tpu_torch import Alphabet


class TestAlphabet(unittest.TestCase):
    def test_len_default(self):
        self.assertEqual(len(Alphabet()), 24)
        self.assertEqual(len(Alphabet("ATGC")), 4)

    def test_contains_getitem(self):
        a = Alphabet("ATGC")
        self.assertIn("A", a)
        self.assertNotIn("X", a)
        self.assertEqual(a[0], "A")
        self.assertEqual(a[-1], "C")
        for bad in (-5, 4):
            with self.assertRaises(IndexError):
                a[bad]

    def test_eq_and_pickle(self):
        a = Alphabet("ATGC")
        self.assertEqual(a, Alphabet("ATGC"))
        self.assertEqual(a, "ATGC")
        self.assertNotEqual(a, Alphabet("TCGA"))
        self.assertEqual(a, pickle.loads(pickle.dumps(a)))

    def test_init_errors(self):
        for bad in ("AAAA", "AtgC", "A[]C", "ABCDEFGHIJKLMNOPQRSTUVWXYZ" * 2):
            with self.assertRaises(ValueError):
                Alphabet(bad)

    def test_encode_decode(self):
        a = Alphabet("ATGC")
        self.assertEqual(a.encode("ATGC"), bytes([0, 1, 2, 3]))
        self.assertEqual(a.encode(b"ATGC"), bytes([0, 1, 2, 3]))
        self.assertEqual(a.decode(bytes([0, 1, 2, 3])), "ATGC")
        self.assertEqual(
            a.decode(memoryview(bytearray([0, 1, 2, 3]))), "ATGC"
        )
        with self.assertRaises(ValueError):
            a.decode(bytes([0, 7]))

    def test_encode_wildcard(self):
        a = Alphabet("ATGC*")
        self.assertEqual(a.encode("AWC"), bytes([0, 4, 3]))
        with self.assertRaises(ValueError):
            Alphabet("ATGC").encode("AWC")
        with self.assertRaises(ValueError):
            a.encode("A-C")
