"""Post-install smoke tests (golden answers from the upstream suite).

The pinned numbers are upstream PyOpal's own
(``src/pyopal/tests/test_aligner.py:38-131``): query ``ACCTCG`` vs
target ``AACCGCTG`` under BLOSUM50, gap_open=3, gap_extend=1 must score
NW=44 (ends (5,7), starts (0,0)) and SW=47 (target_start 1).  One tiny
database bounds the cost.
"""

import pickle
import unittest

import pyopal_tpu_torch

from ._devices import devices


class TestGolden(unittest.TestCase):
    QUERY = "ACCTCG"
    TARGET = "AACCGCTG"

    @classmethod
    def setUpClass(cls):
        cls.database = pyopal_tpu_torch.Database([cls.TARGET])

    def test_nw_full(self):
        for device in devices():
            with self.subTest(device=device):
                aligner = pyopal_tpu_torch.Aligner(device=device)
                hit = aligner.align(
                    self.QUERY, self.database, mode="full", algorithm="nw"
                )[0]
                self.assertEqual(hit.score, 44)
                self.assertEqual(hit.query_end, 5)
                self.assertEqual(hit.target_end, 7)
                self.assertEqual(hit.query_start, 0)
                self.assertEqual(hit.target_start, 0)
                self.assertEqual(hit.cigar(), "1D5M1D1M")
                self.assertEqual(hit.coverage("query"), 1.0)
                self.assertEqual(hit.coverage("target"), 0.875)

    def test_sw_modes(self):
        for device in devices():
            aligner = pyopal_tpu_torch.Aligner(device=device)
            for mode in ("score", "end", "full"):
                with self.subTest(device=device, mode=mode):
                    hit = aligner.align(
                        self.QUERY, self.database, mode=mode, algorithm="sw"
                    )[0]
                    self.assertEqual(hit.score, 47)
                    if mode != "score":
                        self.assertEqual(hit.query_end, 5)
                        self.assertEqual(hit.target_end, 7)
                    if mode == "full":
                        self.assertEqual(hit.target_start, 1)

    def test_align_generator(self):
        for device in devices():
            with self.subTest(device=device):
                hits = list(
                    pyopal_tpu_torch.align(
                        self.QUERY, [self.TARGET], algorithm="nw",
                        ordered=True, device=device,
                    )
                )
                self.assertEqual(len(hits), 1)
                self.assertEqual(hits[0].score, 44)
                self.assertEqual(hits[0].target_index, 0)


class TestContainers(unittest.TestCase):
    def test_alphabet(self):
        alphabet = pyopal_tpu_torch.Alphabet()
        encoded = alphabet.encode("ARNDCA")
        self.assertEqual(alphabet.decode(encoded), "ARNDCA")
        self.assertEqual(alphabet, pickle.loads(pickle.dumps(alphabet)))

    def test_database(self):
        db = pyopal_tpu_torch.Database(["MKV", "AR", "ARNDC"])
        self.assertEqual(len(db), 3)
        self.assertEqual(db[1], "AR")
        self.assertEqual(db.lengths, [3, 2, 5])
        sub = db.extract([0, 2])
        self.assertEqual(list(sub.lengths), [3, 5])
        rt = pickle.loads(pickle.dumps(db))
        self.assertEqual(list(rt.lengths), [3, 2, 5])

    def test_results(self):
        r = pyopal_tpu_torch.ScoreResult(3, 47)
        self.assertEqual(r, pickle.loads(pickle.dumps(r)))
        e = pyopal_tpu_torch.EndResult(3, 47, 5, 7)
        self.assertEqual(e.query_end, 5)
        self.assertEqual(e, pickle.loads(pickle.dumps(e)))

    def test_fasta_round_trip(self):
        import os
        import tempfile

        names, db = pyopal_tpu_torch.read_fasta(b">a x\nMKV\n>b\nARNDC\n")
        self.assertEqual(names, ["a", "b"])
        self.assertEqual(list(db), ["MKV", "ARNDC"])
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "db")
            pyopal_tpu_torch.save_database(path, db, names=names)
            names2, db2 = pyopal_tpu_torch.load_database(path)
        self.assertEqual(names2, names)
        self.assertEqual(list(db2), list(db))

    def test_scoring_matrix_text_round_trip(self):
        m = pyopal_tpu_torch.ScoringMatrix.from_name("BLOSUM50")
        again = pyopal_tpu_torch.ScoringMatrix.from_text(m.to_text())
        self.assertEqual(again.alphabet, m.alphabet)
        self.assertEqual(
            again, pyopal_tpu_torch.ScoringMatrix(m.data, m.alphabet)
        )

    def test_pam_generation(self):
        # PAM30's widest value stresses the text renderer; PAM200 is a
        # generated (non-transcribed) table
        m30 = pyopal_tpu_torch.ScoringMatrix.from_name("PAM30")
        self.assertEqual(
            pyopal_tpu_torch.ScoringMatrix.from_text(m30.to_text()),
            pyopal_tpu_torch.ScoringMatrix(m30.data, m30.alphabet),
        )
        m200 = pyopal_tpu_torch.ScoringMatrix.from_name("PAM200")
        self.assertEqual(m200.name, "PAM200")
        self.assertTrue(m200.is_integer())
        self.assertEqual(
            pyopal_tpu_torch.ScoringMatrix.pam(250),
            pyopal_tpu_torch.ScoringMatrix.from_name("PAM250"),
        )

    def test_parallel_import_surface(self):
        from pyopal_tpu_torch.parallel import align_arrays_sharded, device_mesh

        self.assertTrue(callable(align_arrays_sharded))
        self.assertTrue(callable(device_mesh))


if __name__ == "__main__":
    unittest.main()
