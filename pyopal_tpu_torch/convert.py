"""Carry the reference's state across as numpy arrays.

The "weights" of this system are the scoring matrix, its alphabet and
the encoded database.  These functions build the port's objects from
the arrays a `pyopal_tpu` session holds (``ScoringMatrix.data`` /
``.alphabet``, ``Database.get_encoded``), so both packages can be fed
the same state without either importing the other.
"""

from __future__ import annotations

import numpy as np

from .database import Database
from .matrices import ScoringMatrix


def scoring_matrix_from_numpy(letters: str, matrix, name=None):
    """A `ScoringMatrix` over ``letters`` with the values of ``matrix``
    (a square array, one row and column per letter)."""
    return ScoringMatrix(np.asarray(matrix, dtype=np.float32), letters, name)


def database_from_numpy(letters: str, encoded_sequences) -> Database:
    """A `Database` over ``letters`` holding the already-encoded
    sequences (one integer array of symbol codes each).

    Raises:
        `ValueError`: When a code is negative or beyond the alphabet.
    """
    db = Database(alphabet=letters)
    encoded = []
    for seq in encoded_sequences:
        arr = np.asarray(seq)
        if arr.ndim != 1:
            raise ValueError("encoded sequences must be 1-D arrays")
        if arr.size and (arr.min() < 0 or arr.max() >= len(letters)):
            raise ValueError("encoded sequence holds a code outside the alphabet")
        arr = np.array(arr, dtype=np.uint8)
        arr.setflags(write=False)
        encoded.append(arr)
    if encoded:
        with db.lock.write:
            db._sequences.extend(encoded)
            db._bump()
    return db
