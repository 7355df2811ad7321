"""In-wheel `Database` container tests.

Port of ``pyopal_tpu/tests/test_database.py``: upstream PyOpal's
container contract (``src/pyopal/tests/test_database.py``): MutableSequence
semantics, subsetting, pickling — all host-side, no kernel dispatch.
"""

import pickle
import unittest

from pyopal_tpu_torch import Database


class TestDatabase(unittest.TestCase):
    def test_contains(self):
        db = Database(["ATGC", "ATTTAC", "TTACCG"])
        for seq in ("ATGC", "ATTTAC", "TTACCG"):
            self.assertIn(seq, db)
        self.assertNotIn("TAACCG", db)
        with self.assertRaises(TypeError):
            1 in db

    def test_lengths_and_total(self):
        db = Database(["ATGC", "ATTC", "TTCG"])
        self.assertEqual(db.lengths, [4, 4, 4])
        self.assertEqual(db.total_length, 12)

    def test_getitem(self):
        sequences = ["ATGC", "ATTC", "TTCG"]
        for convert in (str, lambda s: s.encode("ascii")):
            db = Database([convert(s) for s in sequences])
            for i in range(3):
                self.assertEqual(db[i], sequences[i])
                self.assertEqual(db[-(i + 1)], sequences[-(i + 1)])

    def test_getitem_slice(self):
        sequences = ["ATGC", "ATTC", "TTCG", "TTAT", "AAAC"]
        db = Database(sequences)
        self.assertEqual(list(db[:2]), sequences[:2])
        self.assertEqual(list(db[1:4:2]), sequences[1:4:2])
        self.assertEqual(list(db[1::-1]), sequences[1::-1])

    def test_getitem_index_error(self):
        db = Database(["ATGC", "ATTC", "TTCG"])
        for bad in (3, -4, -8):
            with self.assertRaises(IndexError):
                db[bad]

    def test_reverse(self):
        sequences = ["ATGC", "ATTC", "TTCG"]
        db = Database(sequences)
        db.reverse()
        self.assertEqual(list(db), list(reversed(sequences)))
        empty = Database()
        empty.reverse()
        self.assertEqual(len(empty), 0)

    def test_pickle(self):
        sequences = ["ATGC", "ATTC", "TTCG"]
        db = Database(sequences)
        self.assertEqual(list(pickle.loads(pickle.dumps(db))), sequences)

    def test_insert_clamps(self):
        db = Database(["ATGC", "ATTC"])
        db.insert(1, "TTCC")
        db.insert(-10, "TTTT")
        db.insert(10, "AAAA")
        self.assertEqual(
            list(db), ["TTTT", "ATGC", "TTCC", "ATTC", "AAAA"]
        )

    def test_delitem(self):
        db = Database(["ATGC", "ATTC", "TTCG"])
        del db[1]
        del db[-2]
        del db[0]
        self.assertEqual(list(db), [])
        with self.assertRaises(IndexError):
            del db[0]

    def test_setitem(self):
        db = Database(["ATGC", "ATTC", "TTCG"])
        db[2] = "AAAT"
        self.assertEqual(list(db), ["ATGC", "ATTC", "AAAT"])
        with self.assertRaises(IndexError):
            db[5] = "TCGA"

    def test_mask(self):
        db = Database(["AAAA", "CCCC", "KKKK", "FFFF"])
        self.assertEqual(
            list(db.mask([True, False, False, True])), ["AAAA", "FFFF"]
        )
        with self.assertRaises(IndexError):
            db.mask([True])
        with self.assertRaises(IndexError):
            db.mask([True] * 5)

    def test_extract(self):
        db = Database(["AAAA", "CCCC", "KKKK", "FFFF"])
        self.assertEqual(list(db.extract([2, 0])), ["KKKK", "AAAA"])
        with self.assertRaises(IndexError):
            db.extract([4])
        with self.assertRaises(IndexError):
            db.extract([-1])

    def test_clear(self):
        db = Database(["ATGC", "ATTC"])
        db.clear()
        self.assertEqual(list(db), [])
