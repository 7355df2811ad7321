"""In-wheel engine cross-check: the kernels against the scalar oracle.

Port of ``pyopal_tpu/tests/test_engine.py``.  Runs K1, the ragged
kernel (`pyopal_tpu_torch.ops.ragged.search_flat` with ``safe_pad``),
over a small ragged database — an empty target, lengths straddling the
64-column chunk quantum — and asserts score/end equality with the
scalar oracle (`pyopal_tpu_torch.ops.naive`) for a local and a global
algorithm: on the CPU through the kernel's plain version, and on a CUDA
card through the kernel itself.  This is the installed-artifact analog
of the repository's oracle gates.
"""

import unittest

import numpy as np

from ._devices import devices


class TestEngineOracle(unittest.TestCase):
    def test_ragged_kernel_matches_oracle(self):
        import torch

        from pyopal_tpu_torch.matrices import ScoringMatrix
        from pyopal_tpu_torch.ops import naive, packing
        from pyopal_tpu_torch.ops import ragged as pr

        S = ScoringMatrix.from_name("BLOSUM62").int_data()
        rng = np.random.default_rng(7)
        seqs = [
            rng.integers(0, 20, int(n)).astype(np.uint8)
            for n in (0, 3, 63, 64, 65, 30)
        ]
        fp = packing.pack_sequences_flat(seqs)
        idx = fp.indices.reshape(-1)
        query = rng.integers(0, 20, 40).astype(np.uint8)

        for device in devices():
            flat = [
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (fp.flat_targets, fp.lengths, fp.block_of_step,
                          fp.chunk_of_step, fp.last_of_step)
            ]
            profs = torch.from_numpy(pr.make_profiles_host([query], S))
            qlens = torch.tensor([len(query)], dtype=torch.int32)
            for algo in ("sw", "nw"):
                with self.subTest(device=device, algorithm=algo):
                    s, qe, te = (
                        x.reshape(-1).cpu().numpy()
                        for x in pr.search_flat(
                            profs.to(device), qlens.to(device), *flat,
                            3, 1, algo, True, fp.chunk, safe_pad=True,
                        )
                    )
                    for pos in range(idx.shape[0]):
                        i = idx[pos]
                        if i < 0:
                            continue
                        ns, nqe, nte = naive.score_end(
                            query, seqs[i], S, 3, 1, algo
                        )
                        self.assertEqual(ns, s[pos], (algo, i))
                        if len(seqs[i]):
                            self.assertEqual(
                                (nqe, nte), (qe[pos], te[pos]), (algo, i)
                            )
