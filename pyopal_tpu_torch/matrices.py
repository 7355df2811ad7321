"""Substitution-matrix provider.

Port of ``pyopal_tpu/matrices.py``, copied unchanged apart from this
note: the same tables, `from_name` catalog and error messages.

The reference delegates scoring matrices to the external
``scoring-matrices`` package (upstream PyOpal ``src/pyopal/lib.pyx:39``,
``pyproject.toml:44-46``).  This module is the equivalent provider for
the TPU-native build: named BLOSUM/PAM tables (transcribed from the
public NCBI distributions), custom matrices, and the small API surface
the aligner needs (``from_name``, ``alphabet``, ``is_integer``, ``size``
plus array access).

The matrix is stored as a dense ``numpy`` array; the aligner derives
from it the ``(alphabet, query_len)`` bf16 query profile that feeds the
one-hot MXU matmul in the Pallas kernel.
"""

from __future__ import annotations

import math
import operator

import numpy as np

_PROTEIN_ALPHABET = "ARNDCQEGHILKMFPSTWYVBZX*"

# --- Bundled tables -----------------------------------------------------------
# Values transcribed from the public NCBI / EMBOSS matrix distributions.
# Row/column order follows _PROTEIN_ALPHABET.  BLOSUM50 is the load-bearing
# default (reference default at lib.pyx:1153) and is cross-checked by the
# golden alignment scores (test_aligner.py:38-131 -> NW=44 / SW=47).

_TABLES = {
    "BLOSUM50": """
 5 -2 -1 -2 -1 -1 -1  0 -2 -1 -2 -1 -1 -3 -1  1  0 -3 -2  0 -2 -1 -1 -5
-2  7 -1 -2 -4  1  0 -3  0 -4 -3  3 -2 -3 -3 -1 -1 -3 -1 -3 -1  0 -1 -5
-1 -1  7  2 -2  0  0  0  1 -3 -4  0 -2 -4 -2  1  0 -4 -2 -3  4  0 -1 -5
-2 -2  2  8 -4  0  2 -1 -1 -4 -4 -1 -4 -5 -1  0 -1 -5 -3 -4  5  1 -1 -5
-1 -4 -2 -4 13 -3 -3 -3 -3 -2 -2 -3 -2 -2 -4 -1 -1 -5 -3 -1 -3 -3 -2 -5
-1  1  0  0 -3  7  2 -2  1 -3 -2  2  0 -4 -1  0 -1 -1 -1 -3  0  4 -1 -5
-1  0  0  2 -3  2  6 -3  0 -4 -3  1 -2 -3 -1 -1 -1 -3 -2 -3  1  5 -1 -5
 0 -3  0 -1 -3 -2 -3  8 -2 -4 -4 -2 -3 -4 -2  0 -2 -3 -3 -4 -1 -2 -2 -5
-2  0  1 -1 -3  1  0 -2 10 -4 -3  0 -1 -1 -2 -1 -2 -3  2 -4  0  0 -1 -5
-1 -4 -3 -4 -2 -3 -4 -4 -4  5  2 -3  2  0 -3 -3 -1 -3 -1  4 -4 -3 -1 -5
-2 -3 -4 -4 -2 -2 -3 -4 -3  2  5 -3  3  1 -4 -3 -1 -2 -1  1 -4 -3 -1 -5
-1  3  0 -1 -3  2  1 -2  0 -3 -3  6 -2 -4 -1  0 -1 -3 -2 -3  0  1 -1 -5
-1 -2 -2 -4 -2  0 -2 -3 -1  2  3 -2  7  0 -3 -2 -1 -1  0  1 -3 -1 -1 -5
-3 -3 -4 -5 -2 -4 -3 -4 -1  0  1 -4  0  8 -4 -3 -2  1  4 -1 -4 -4 -2 -5
-1 -3 -2 -1 -4 -1 -1 -2 -2 -3 -4 -1 -3 -4 10 -1 -1 -4 -3 -3 -2 -1 -2 -5
 1 -1  1  0 -1  0 -1  0 -1 -3 -3  0 -2 -3 -1  5  2 -4 -2 -2  0  0 -1 -5
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  2  5 -3 -2  0  0 -1  0 -5
-3 -3 -4 -5 -5 -1 -3 -3 -3 -3 -2 -3 -1  1 -4 -4 -3 15  2 -3 -5 -2 -3 -5
-2 -1 -2 -3 -3 -1 -2 -3  2 -1 -1 -2  0  4 -3 -2 -2  2  8 -1 -3 -2 -1 -5
 0 -3 -3 -4 -1 -3 -3 -4 -4  4  1 -3  1 -1 -3 -2  0 -3 -1  5 -4 -3 -1 -5
-2 -1  4  5 -3  0  1 -1  0 -4 -4  0 -3 -4 -2  0  0 -5 -3 -4  5  2 -1 -5
-1  0  0  1 -3  4  5 -2  0 -3 -3  1 -1 -4 -1  0 -1 -2 -2 -3  2  5 -1 -5
-1 -1 -1 -1 -2 -1 -1 -2 -1 -1 -1 -1 -1 -2 -2 -1  0 -3 -1 -1 -1 -1 -1 -5
-5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5  1
""",
    "BLOSUM62": """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0 -4
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1 -4
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1 -4
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1 -4
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2 -4
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1 -4
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1 -4
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1 -4
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1 -4
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1 -4
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1 -4
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1 -4
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1 -4
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2 -4
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0 -4
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0 -4
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2 -4
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1 -4
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1 -4
-2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1 -4
-1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1 -4
-4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4  1
""",
    "BLOSUM45": """
 5 -2 -1 -2 -1 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -2 -2  0 -1 -1  0 -5
-2  7  0 -1 -3  1  0 -2  0 -3 -2  3 -1 -2 -2 -1 -1 -2 -1 -2 -1  0 -1 -5
-1  0  6  2 -2  0  0  0  1 -2 -3  0 -2 -2 -2  1  0 -4 -2 -3  4  0 -1 -5
-2 -1  2  7 -3  0  2 -1  0 -4 -3  0 -3 -4 -1  0 -1 -4 -2 -3  5  1 -1 -5
-1 -3 -2 -3 12 -3 -3 -3 -3 -3 -2 -3 -2 -2 -4 -1 -1 -5 -3 -1 -2 -3 -2 -5
-1  1  0  0 -3  6  2 -2  1 -2 -2  1  0 -4 -1  0 -1 -2 -1 -3  0  4 -1 -5
-1  0  0  2 -3  2  6 -2  0 -3 -2  1 -2 -3  0  0 -1 -3 -2 -3  1  4 -1 -5
 0 -2  0 -1 -3 -2 -2  7 -2 -4 -3 -2 -2 -3 -2  0 -2 -2 -3 -3 -1 -2 -1 -5
-2  0  1  0 -3  1  0 -2 10 -3 -2 -1  0 -2 -2 -1 -2 -3  2 -3  0  0 -1 -5
-1 -3 -2 -4 -3 -2 -3 -4 -3  5  2 -3  2  0 -2 -2 -1 -2  0  3 -3 -3 -1 -5
-1 -2 -3 -3 -2 -2 -2 -3 -2  2  5 -3  2  1 -3 -3 -1 -2  0  1 -3 -2 -1 -5
-1  3  0  0 -3  1  1 -2 -1 -3 -3  5 -1 -3 -1 -1 -1 -2 -1 -2  0  1 -1 -5
-1 -1 -2 -3 -2  0 -2 -2  0  2  2 -1  6  0 -2 -2 -1 -2  0  1 -2 -1 -1 -5
-2 -2 -2 -4 -2 -4 -3 -3 -2  0  1 -3  0  8 -3 -2 -1  1  3  0 -3 -3 -1 -5
-1 -2 -2 -1 -4 -1  0 -2 -2 -2 -3 -1 -2 -3  9 -1 -1 -3 -3 -3 -2 -1 -1 -5
 1 -1  1  0 -1  0  0  0 -1 -2 -3 -1 -2 -2 -1  4  2 -4 -2 -1  0  0  0 -5
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -1 -1  2  5 -3 -1  0  0 -1  0 -5
-2 -2 -4 -4 -5 -2 -3 -2 -3 -2 -2 -2 -2  1 -3 -4 -3 15  3 -3 -4 -2 -2 -5
-2 -1 -2 -2 -3 -1 -2 -3  2  0  0 -1  0  3 -3 -2 -1  3  8 -1 -2 -2 -1 -5
 0 -2 -3 -3 -1 -3 -3 -3 -3  3  1 -2  1  0 -3 -1  0 -3 -1  5 -3 -3 -1 -5
-1 -1  4  5 -2  0  1 -1  0 -3 -3  0 -2 -3 -2  0  0 -4 -2 -3  4  2 -1 -5
-1  0  0  1 -3  4  4 -2  0 -3 -2  1 -1 -3 -1  0 -1 -2 -2 -3  2  4 -1 -5
 0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -2 -1 -1 -1 -1 -1 -5
-5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5  1
""",
    "BLOSUM80": """
 5 -2 -2 -2 -1 -1 -1  0 -2 -2 -2 -1 -1 -3 -1  1  0 -3 -2  0 -2 -1 -1 -6
-2  6 -1 -2 -4  1 -1 -3  0 -3 -3  2 -2 -4 -2 -1 -1 -4 -3 -3 -2  0 -1 -6
-2 -1  6  1 -3  0 -1 -1  0 -4 -4  0 -3 -4 -3  0  0 -4 -3 -4  4  0 -1 -6
-2 -2  1  6 -4 -1  1 -2 -2 -4 -5 -1 -4 -4 -2 -1 -1 -6 -4 -4  4  1 -2 -6
-1 -4 -3 -4  9 -4 -5 -4 -4 -2 -2 -4 -2 -3 -4 -2 -1 -3 -3 -1 -4 -4 -3 -6
-1  1  0 -1 -4  6  2 -2  1 -3 -3  1  0 -4 -2  0 -1 -3 -2 -3  0  3 -1 -6
-1 -1 -1  1 -5  2  6 -3  0 -4 -4  1 -2 -4 -2  0 -1 -4 -3 -3  1  4 -1 -6
 0 -3 -1 -2 -4 -2 -3  6 -3 -5 -4 -2 -4 -4 -3 -1 -2 -4 -4 -4 -1 -3 -2 -6
-2  0  0 -2 -4  1  0 -3  8 -4 -3 -1 -2 -2 -3 -1 -2 -3  2 -4 -1  0 -2 -6
-2 -3 -4 -4 -2 -3 -4 -5 -4  5  1 -3  1 -1 -4 -3 -1 -3 -2  3 -4 -4 -2 -6
-2 -3 -4 -5 -2 -3 -4 -4 -3  1  4 -3  2  0 -3 -3 -2 -2 -2  1 -4 -3 -2 -6
-1  2  0 -1 -4  1  1 -2 -1 -3 -3  5 -2 -4 -1 -1 -1 -4 -3 -3 -1  1 -1 -6
-1 -2 -3 -4 -2  0 -2 -4 -2  1  2 -2  6  0 -3 -2 -1 -2 -2  1 -3 -1 -1 -6
-3 -4 -4 -4 -3 -4 -4 -4 -2 -1  0 -4  0  6 -4 -3 -2  0  3 -1 -4 -4 -2 -6
-1 -2 -3 -2 -4 -2 -2 -3 -3 -4 -3 -1 -3 -4  8 -1 -2 -5 -4 -3 -2 -2 -2 -6
 1 -1  0 -1 -2  0  0 -1 -1 -3 -3 -1 -2 -3 -1  5  1 -4 -2 -2  0  0 -1 -6
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -2 -1 -1 -2 -2  1  5 -4 -2  0 -1 -1 -1 -6
-3 -4 -4 -6 -3 -3 -4 -4 -3 -3 -2 -4 -2  0 -5 -4 -4 11  2 -3 -5 -4 -3 -6
-2 -3 -3 -4 -3 -2 -3 -4  2 -2 -2 -3 -2  3 -4 -2 -2  2  7 -2 -3 -3 -2 -6
 0 -3 -4 -4 -1 -3 -3 -4 -4  3  1 -3  1 -1 -3 -2  0 -3 -2  4 -4 -3 -1 -6
-2 -2  4  4 -4  0  1 -1 -1 -4 -4 -1 -3 -4 -2  0 -1 -5 -3 -4  4  0 -2 -6
-1  0  0  1 -4  3  4 -3  0 -4 -3  1 -1 -4 -2  0 -1 -4 -3 -3  0  4 -1 -6
-1 -1 -1 -2 -3 -1 -1 -2 -2 -2 -2 -1 -1 -2 -2 -1 -1 -3 -2 -1 -2 -1 -1 -6
-6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6  1
""",
    "BLOSUM90": """
 5 -2 -2 -3 -1 -1 -1  0 -2 -2 -2 -1 -2 -3 -1  1  0 -4 -3 -1 -2 -1 -1 -6
-2  6 -1 -3 -5  1 -1 -3  0 -4 -3  2 -2 -4 -3 -1 -2 -4 -3 -3 -2  0 -2 -6
-2 -1  7  1 -4  0 -1 -1  0 -4 -4  0 -3 -4 -3  0  0 -5 -3 -4  4 -1 -2 -6
-3 -3  1  7 -5 -1  1 -2 -2 -5 -5 -1 -4 -5 -3 -1 -2 -6 -4 -5  4  0 -2 -6
-1 -5 -4 -5  9 -4 -6 -4 -5 -2 -2 -4 -2 -3 -4 -2 -2 -4 -4 -2 -4 -5 -3 -6
-1  1  0 -1 -4  7  2 -3  1 -4 -3  1  0 -4 -2 -1 -1 -3 -3 -3 -1  4 -1 -6
-1 -1 -1  1 -6  2  6 -3 -1 -4 -4  0 -3 -5 -2 -1 -1 -5 -4 -3  0  4 -2 -6
 0 -3 -1 -2 -4 -3 -3  6 -3 -5 -5 -2 -4 -5 -3 -1 -3 -4 -5 -5 -2 -3 -2 -6
-2  0  0 -2 -5  1 -1 -3  8 -4 -4 -1 -3 -2 -3 -2 -2 -3  1 -4 -1  0 -2 -6
-2 -4 -4 -5 -2 -4 -4 -5 -4  5  1 -4  1 -1 -4 -3 -1 -4 -2  3 -5 -4 -2 -6
-2 -3 -4 -5 -2 -3 -4 -5 -4  1  5 -3  2  0 -4 -3 -2 -3 -2  0 -5 -4 -2 -6
-1  2  0 -1 -4  1  0 -2 -1 -4 -3  6 -2 -4 -2 -1 -1 -5 -3 -3 -1  1 -1 -6
-2 -2 -3 -4 -2  0 -3 -4 -3  1  2 -2  7 -1 -3 -2 -1 -2 -2  0 -4 -2 -1 -6
-3 -4 -4 -5 -3 -4 -5 -5 -2 -1  0 -4 -1  7 -4 -3 -3  0  3 -2 -4 -4 -2 -6
-1 -3 -3 -3 -4 -2 -2 -3 -3 -4 -4 -2 -3 -4  8 -2 -2 -5 -4 -3 -3 -2 -2 -6
 1 -1  0 -1 -2 -1 -1 -1 -2 -3 -3 -1 -2 -3 -2  5  1 -4 -3 -2  0 -1 -1 -6
 0 -2  0 -2 -2 -1 -1 -3 -2 -1 -2 -1 -1 -3 -2  1  6 -4 -2 -1 -1 -1 -1 -6
-4 -4 -5 -6 -4 -3 -5 -4 -3 -4 -3 -5 -2  0 -5 -4 -4 11  2 -3 -6 -4 -3 -6
-3 -3 -3 -4 -4 -3 -4 -5  1 -2 -2 -3 -2  3 -4 -3 -2  2  8 -3 -4 -3 -2 -6
-1 -3 -4 -5 -2 -3 -3 -5 -4  3  0 -3  0 -2 -3 -2 -1 -3 -3  5 -4 -3 -2 -6
-2 -2  4  4 -4 -1  0 -2 -1 -5 -5 -1 -4 -4 -3  0 -1 -6 -4 -4  4  0 -2 -6
-1  0 -1  0 -5  4  4 -3  0 -4 -4  1 -2 -4 -2 -1 -1 -4 -3 -3  0  4 -1 -6
-1 -2 -2 -2 -3 -1 -2 -2 -2 -2 -2 -1 -1 -2 -2 -1 -1 -3 -2 -2 -2 -1 -2 -6
-6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6 -6  1
""",
    "PAM250": """
 2 -2  0  0 -2  0  0  1 -1 -1 -2 -1 -1 -3  1  1  1 -6 -3  0  0  0  0 -8
-2  6  0 -1 -4  1 -1 -3  2 -2 -3  3  0 -4  0  0 -1  2 -4 -2 -1  0 -1 -8
 0  0  2  2 -4  1  1  0  2 -2 -3  1 -2 -3  0  1  0 -4 -2 -2  2  1  0 -8
 0 -1  2  4 -5  2  3  1  1 -2 -4  0 -3 -6 -1  0  0 -7 -4 -2  3  3 -1 -8
-2 -4 -4 -5 12 -5 -5 -3 -3 -2 -6 -5 -5 -4 -3  0 -2 -8  0 -2 -4 -5 -3 -8
 0  1  1  2 -5  4  2 -1  3 -2 -2  1 -1 -5  0 -1 -1 -5 -4 -2  1  3 -1 -8
 0 -1  1  3 -5  2  4  0  1 -2 -3  0 -2 -5 -1  0  0 -7 -4 -2  3  3 -1 -8
 1 -3  0  1 -3 -1  0  5 -2 -3 -4 -2 -3 -5  0  1  0 -7 -5 -1  0  0 -1 -8
-1  2  2  1 -3  3  1 -2  6 -2 -2  0 -2 -2  0 -1 -1 -3  0 -2  1  2 -1 -8
-1 -2 -2 -2 -2 -2 -2 -3 -2  5  2 -2  2  1 -2 -1  0 -5 -1  4 -2 -2 -1 -8
-2 -3 -3 -4 -6 -2 -3 -4 -2  2  6 -3  4  2 -3 -3 -2 -2 -1  2 -3 -3 -1 -8
-1  3  1  0 -5  1  0 -2  0 -2 -3  5  0 -5 -1  0  0 -3 -4 -2  1  0 -1 -8
-1  0 -2 -3 -5 -1 -2 -3 -2  2  4  0  6  0 -2 -2 -1 -4 -2  2 -2 -2 -1 -8
-3 -4 -3 -6 -4 -5 -5 -5 -2  1  2 -5  0  9 -5 -3 -3  0  7 -1 -4 -5 -2 -8
 1  0  0 -1 -3  0 -1  0  0 -2 -3 -1 -2 -5  6  1  0 -6 -5 -1 -1  0 -1 -8
 1  0  1  0  0 -1  0  1 -1 -1 -3  0 -2 -3  1  2  1 -2 -3 -1  0  0  0 -8
 1 -1  0  0 -2 -1  0  0 -1  0 -2  0 -1 -3  0  1  3 -5 -3  0  0 -1  0 -8
-6  2 -4 -7 -8 -5 -7 -7 -3 -5 -2 -3 -4  0 -6 -2 -5 17  0 -6 -5 -6 -4 -8
-3 -4 -2 -4  0 -4 -4 -5  0 -1 -1 -4 -2  7 -5 -3 -3  0 10 -2 -3 -4 -2 -8
 0 -2 -2 -2 -2 -2 -2 -1 -2  4  2 -2  2 -1 -1 -1  0 -6 -2  4 -2 -2 -1 -8
 0 -1  2  3 -4  1  3  0  1 -2 -3  1 -2 -4 -1  0  0 -5 -3 -2  3  2 -1 -8
 0  0  1  3 -5  3  3  0  2 -2 -3  0 -2 -5  0  0 -1 -6 -4 -2  2  3 -1 -8
 0 -1  0 -1 -3 -1 -1 -1 -1 -1 -1 -1 -1 -2 -1  0  0 -4 -2 -1 -1 -1 -1 -8
-8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8  1
""",
    "PAM120": """
 3 -3 -1  0 -3 -1  0  1 -3 -1 -3 -2 -2 -4  1  1  1 -7 -4  0  0 -1 -1 -8
-3  6 -1 -3 -4  1 -3 -4  1 -2 -4  2 -1 -5 -1 -1 -2  1 -5 -3 -2 -1 -2 -8
-1 -1  4  2 -5  0  1  0  2 -2 -4  1 -3 -4 -2  1  0 -4 -2 -3  3  0 -1 -8
 0 -3  2  5 -7  1  3  0  0 -3 -5 -1 -4 -7 -3  0 -1 -8 -5 -3  4  3 -2 -8
-3 -4 -5 -7  9 -7 -7 -4 -4 -3 -7 -7 -6 -6 -4  0 -3 -8 -1 -3 -6 -7 -4 -8
-1  1  0  1 -7  6  2 -3  3 -3 -2  0 -1 -6  0 -2 -2 -6 -5 -3  0  4 -1 -8
 0 -3  1  3 -7  2  5 -1 -1 -3 -4 -1 -3 -7 -2 -1 -2 -8 -5 -3  3  4 -1 -8
 1 -4  0  0 -4 -3 -1  5 -4 -4 -5 -3 -4 -5 -2  1 -1 -8 -6 -2  0 -2 -2 -8
-3  1  2  0 -4  3 -1 -4  7 -4 -3 -2 -4 -3 -1 -2 -3 -3 -1 -3  1  1 -2 -8
-1 -2 -2 -3 -3 -3 -3 -4 -4  6  1 -3  1  0 -3 -2  0 -6 -2  3 -3 -3 -1 -8
-3 -4 -4 -5 -7 -2 -4 -5 -3  1  5 -4  3  0 -3 -4 -3 -3 -2  1 -4 -3 -2 -8
-2  2  1 -1 -7  0 -1 -3 -2 -3 -4  5  0 -7 -2 -1 -1 -5 -5 -4  0 -1 -2 -8
-2 -1 -3 -4 -6 -1 -3 -4 -4  1  3  0  8 -1 -3 -2 -1 -6 -4  1 -4 -2 -2 -8
-4 -5 -4 -7 -6 -6 -7 -5 -3  0  0 -7 -1  8 -5 -3 -4 -1  4 -3 -5 -6 -3 -8
 1 -1 -2 -3 -4  0 -2 -2 -1 -3 -3 -2 -3 -5  6  1 -1 -7 -6 -2 -2 -1 -2 -8
 1 -1  1  0  0 -2 -1  1 -2 -2 -4 -1 -2 -3  1  3  2 -2 -3 -2  0 -1 -1 -8
 1 -2  0 -1 -3 -2 -2 -1 -3  0 -3 -1 -1 -4 -1  2  4 -6 -3  0  0 -2 -1 -8
-7  1 -4 -8 -8 -6 -8 -8 -3 -6 -3 -5 -6 -1 -7 -2 -6 12 -2 -8 -6 -7 -5 -8
-4 -5 -2 -5 -1 -5 -5 -6 -1 -2 -2 -5 -4  4 -6 -3 -3 -2  8 -3 -3 -5 -3 -8
 0 -3 -3 -3 -3 -3 -3 -2 -3  3  1 -4  1 -3 -2 -2  0 -8 -3  5 -3 -3 -1 -8
 0 -2  3  4 -6  0  3  0  1 -3 -4  0 -4 -5 -2  0  0 -6 -3 -3  4  2 -1 -8
-1 -1  0  3 -7  4  4 -2  1 -3 -3 -1 -2 -6 -1 -1 -2 -7 -5 -3  2  4 -1 -8
-1 -2 -1 -2 -4 -1 -1 -2 -2 -1 -2 -2 -2 -3 -2 -1 -1 -5 -3 -1 -1 -1 -2 -8
-8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8 -8  1
""",
    "PAM70": """
 5 -4 -2 -1 -4 -2 -1  0 -4 -2 -4 -4 -3 -6  0  1  1 -9 -5 -1 -1 -1 -2 -11
-4  8 -3 -6 -5  0 -5 -6  0 -3 -6  2 -2 -7 -2 -1 -4  0 -7 -5 -4 -2 -3 -11
-2 -3  6  3 -7 -1  0 -1  1 -3 -5  0 -5 -6 -3  1  0 -6 -3 -5  5 -1 -2 -11
-1 -6  3  6 -9  0  3 -1 -1 -5 -8 -2 -7 -10 -4 -1 -2 -10 -7 -5  5  2 -3 -11
-4 -5 -7 -9  9 -9 -9 -6 -5 -4 -10 -9 -9 -8 -5 -1 -5 -11 -2 -4 -8 -9 -6 -11
-2  0 -1  0 -9  7  2 -4  2 -5 -3 -1 -2 -9 -1 -3 -3 -8 -8 -4 -1  5 -2 -11
-1 -5  0  3 -9  2  6 -2 -2 -4 -6 -2 -4 -9 -3 -2 -3 -11 -6 -4  2  5 -3 -11
 0 -6 -1 -1 -6 -4 -2  6 -6 -6 -7 -5 -6 -7 -3  0 -3 -10 -9 -3 -1 -3 -3 -11
-4  0  1 -1 -5  2 -2 -6  8 -6 -4 -3 -6 -4 -2 -3 -4 -5 -1 -4  0  1 -3 -11
-2 -3 -3 -5 -4 -5 -4 -6 -6  7  1 -4  1  0 -5 -4 -1 -9 -4  3 -4 -4 -3 -11
-4 -6 -5 -8 -10 -3 -6 -7 -4  1  6 -5  2 -1 -5 -6 -4 -4 -4  0 -6 -4 -4 -11
-4  2  0 -2 -9 -1 -2 -5 -3 -4 -5  6  0 -9 -4 -2 -1 -7 -7 -6 -1 -2 -3 -11
-3 -2 -5 -7 -9 -2 -4 -6 -6  1  2  0 10 -2 -5 -3 -2 -8 -7  0 -6 -3 -3 -11
-6 -7 -6 -10 -8 -9 -9 -7 -4  0 -1 -9 -2  8 -7 -4 -6 -2  4 -5 -7 -9 -5 -11
 0 -2 -3 -4 -5 -1 -3 -3 -2 -5 -5 -4 -5 -7  7  0 -2 -9 -9 -3 -4 -2 -3 -11
 1 -1  1 -1 -1 -3 -2  0 -3 -4 -6 -2 -3 -4  0  5  2 -3 -5 -3  0 -2 -1 -11
 1 -4  0 -2 -5 -3 -3 -3 -4 -1 -4 -1 -2 -6 -2  2  6 -8 -4 -1 -1 -3 -2 -11
-9  0 -6 -10 -11 -8 -11 -10 -5 -9 -4 -7 -8 -2 -9 -3 -8 13 -3 -10 -7 -10 -7 -11
-5 -7 -3 -7 -2 -8 -6 -9 -1 -4 -4 -7 -7  4 -9 -5 -4 -3  9 -5 -4 -7 -5 -11
-1 -5 -5 -5 -4 -4 -4 -3 -4  3  0 -6  0 -5 -3 -3 -1 -10 -5  6 -5 -4 -2 -11
-1 -4  5  5 -8 -1  2 -1  0 -4 -6 -1 -6 -7 -4  0 -1 -7 -4 -5  5  1 -2 -11
-1 -2 -1  2 -9  5  5 -3  1 -4 -4 -2 -3 -9 -2 -2 -3 -10 -7 -4  1  5 -3 -11
-2 -3 -2 -3 -6 -2 -3 -3 -3 -3 -4 -3 -3 -5 -3 -1 -2 -7 -5 -2 -2 -3 -3 -11
-11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11 -11  1
""",
    # VTML80: the ML-estimated variable-time substitution matrix of
    # Mueller & Vingron (2000) at PAM distance 80, as distributed with
    # MMseqs2 (data/VTML80.out) — the same source the reference's
    # ``scoring-matrices`` dependency bundles; the reference's own test
    # suite constructs its Aligner from this matrix
    # (upstream PyOpal src/pyopal/tests/test_aligner.py:10-18).
    # Transcribed offline; symmetry/integrality pinned by tests.
    "VTML80": """
 5 -2 -2 -2  1 -1 -1  0 -3 -2 -3 -2 -2 -4  0  2  0 -5 -4  0 -2 -1 -1 -9
-2  8 -1 -3 -4  1 -1 -3  0 -4 -3  4 -2 -5 -2 -1 -1 -4 -3 -4 -2  0 -1 -9
-2 -1  8  3 -3  0  0  0  1 -4 -5  1 -3 -5 -2  1  0 -6 -2 -4  6  0 -1 -9
-2 -3  3  8 -5  0  3 -1 -1 -5 -6  0 -4 -7 -2  0 -1 -7 -5 -5  6  2 -2 -9
 1 -4 -3 -5 13 -4 -5 -4 -4 -2 -3 -5 -2 -2 -5  0 -1 -7 -1 -1 -4 -5 -2 -9
-1  1  0  0 -4  7  2 -3  2 -4 -3  2 -2 -5 -2 -1 -1 -6 -4 -3  0  4 -1 -9
-1 -1  0  3 -5  2  6 -2 -1 -4 -5  1 -4 -6 -2 -1 -1 -7 -5 -3  2  5 -1 -9
 0 -3  0 -1 -4 -3 -2  8 -3 -7 -6 -3 -5 -7 -3  0 -3 -5 -6 -6 -1 -2 -2 -9
-3  0  1 -1 -4  2 -1 -3 11 -5 -4  0 -3 -1 -3 -2 -3 -3  2 -5  0  1 -1 -9
-2 -4 -4 -5 -2 -4 -4 -7 -5  6  3 -4  2  0 -4 -4 -1 -4 -3  4 -4 -4 -1 -9
-3 -3 -5 -6 -3 -3 -5 -6 -4  3  6 -4  3  2 -3 -4 -2 -3 -2  1 -5 -4 -1 -9
-2  4  1  0 -5  2  1 -3  0 -4 -4  6 -2 -6 -2 -1 -1 -6 -4 -4  0  2 -1 -9
-2 -2 -3 -4 -2 -2 -4 -5 -3  2  3 -2  9  1 -4 -3 -1 -4 -3  1 -4 -3 -1 -9
-4 -5 -5 -7 -2 -5 -6 -7 -1  0  2 -6  1 10 -5 -4 -4  1  6 -2 -6 -6 -2 -9
 0 -2 -2 -2 -5 -2 -2 -3 -3 -4 -3 -2 -4 -5 10  0 -1 -7 -6 -3 -2 -2 -2 -9
 2 -1  1  0  0 -1 -1  0 -2 -4 -4 -1 -3 -4  0  4  2 -5 -3 -3  1 -1 -1 -9
 0 -1  0 -1 -1 -1 -1 -3 -3 -1 -2 -1 -1 -4 -1  2  5 -6 -4  0 -1 -1 -1 -9
-5 -4 -6 -7 -7 -6 -7 -5 -3 -4 -3 -6 -4  1 -7 -5 -6 16  3 -5 -7 -7 -3 -9
-4 -3 -2 -5 -1 -4 -5 -6  2 -3 -2 -4 -3  6 -6 -3 -4  3 11 -3 -3 -4 -2 -9
 0 -4 -4 -5 -1 -3 -3 -6 -5  4  1 -4  1 -2 -3 -3  0 -5 -3  5 -4 -3 -1 -9
-2 -2  6  6 -4  0  2 -1  0 -4 -5  0 -4 -6 -2  1 -1 -7 -3 -4  6  1 -1 -9
-1  0  0  2 -5  4  5 -2  1 -4 -4  2 -3 -6 -2 -1 -1 -7 -4 -3  1  5 -1 -9
-1 -1 -1 -2 -2 -1 -1 -2 -1 -1 -1 -1 -1 -2 -2 -1 -1 -3 -2 -1 -1 -1 -1 -9
-9 -9 -9 -9 -9 -9 -9 -9 -9 -9 -9 -9 -9 -9 -9 -9 -9 -9 -9 -9 -9 -9 -9  1
""",
    "PAM30": """
  6 -7 -4 -3 -6 -4 -2 -2 -7 -5 -6 -7 -5 -8 -2  0 -1 -13 -8 -2 -3 -3 -3 -17
 -7  8 -6 -10 -8 -2 -9 -9 -2 -5 -8  0 -4 -9 -4 -3 -6 -2 -10 -8 -7 -4 -6 -17
 -4 -6  8  2 -11 -3 -2 -3  0 -5 -7 -1 -9 -9 -6  0 -2 -8 -4 -8  6 -3 -3 -17
 -3 -10  2  8 -14 -2  2 -3 -4 -7 -12 -4 -11 -15 -8 -4 -5 -15 -11 -8  6  1 -5 -17
 -6 -8 -11 -14 10 -14 -14 -9 -7 -6 -15 -14 -13 -13 -8 -3 -8 -15 -4 -6 -12 -14 -9 -17
 -4 -2 -3 -2 -14  8  1 -7  1 -8 -5 -3 -4 -13 -3 -5 -5 -13 -12 -7 -3  6 -5 -17
 -2 -9 -2  2 -14  1  8 -4 -5 -5 -9 -4 -7 -14 -5 -4 -6 -17 -8 -6  1  6 -5 -17
 -2 -9 -3 -3 -9 -7 -4  6 -9 -11 -10 -7 -8 -9 -6 -2 -6 -15 -14 -5 -3 -5 -5 -17
 -7 -2  0 -4 -7  1 -5 -9  9 -9 -6 -6 -10 -6 -4 -6 -7 -7 -3 -6 -1 -1 -5 -17
 -5 -5 -5 -7 -6 -8 -5 -11 -9  8 -1 -6 -1 -2 -8 -7 -2 -14 -6  2 -6 -6 -5 -17
 -6 -8 -7 -12 -15 -5 -9 -10 -6 -1  7 -8  1 -3 -7 -8 -7 -6 -7 -2 -9 -7 -6 -17
 -7  0 -1 -4 -14 -3 -4 -7 -6 -6 -8  7 -2 -14 -6 -4 -3 -12 -9 -9 -2 -4 -5 -17
 -5 -4 -9 -11 -13 -4 -7 -8 -10 -1  1 -2 11 -4 -8 -5 -4 -13 -11 -1 -10 -5 -5 -17
 -8 -9 -9 -15 -13 -13 -14 -9 -6 -2 -3 -14 -4  9 -10 -6 -9 -4  2 -8 -10 -13 -8 -17
 -2 -4 -6 -8 -8 -3 -5 -6 -4 -8 -7 -6 -8 -10  8 -2 -4 -14 -13 -6 -7 -4 -5 -17
  0 -3  0 -4 -3 -5 -4 -2 -6 -7 -8 -4 -5 -6 -2  6  0 -5 -7 -6 -1 -5 -3 -17
 -1 -6 -2 -5 -8 -5 -6 -6 -7 -2 -7 -3 -4 -9 -4  0  7 -13 -6 -3 -3 -6 -4 -17
-13 -2 -8 -15 -15 -13 -17 -15 -7 -14 -6 -12 -13 -4 -14 -5 -13 13 -5 -15 -10 -14 -11 -17
 -8 -10 -4 -11 -4 -12 -8 -14 -3 -6 -7 -9 -11  2 -13 -7 -6 -5 10 -7 -6 -9 -7 -17
 -2 -8 -8 -8 -6 -7 -6 -5 -6  2 -2 -9 -1 -8 -6 -6 -3 -15 -7  7 -8 -6 -5 -17
 -3 -7  6  6 -12 -3  1 -3 -1 -6 -9 -2 -10 -10 -7 -1 -3 -10 -6 -8  6  0 -5 -17
 -3 -4 -3  1 -14  6  6 -5 -1 -6 -7 -4 -5 -13 -4 -5 -6 -14 -9 -6  0  6 -5 -17
 -3 -6 -3 -5 -9 -5 -5 -5 -5 -5 -6 -5 -5 -8 -5 -3 -4 -11 -7 -5 -5 -5 -5 -17
-17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17 -17  1
""",
}

# the granular BLOSUM clustering series (30..100) lives in its own
# module to keep this one readable
from ._blosum_extra import EXTRA_TABLES as _EXTRA_TABLES

_TABLES.update(_EXTRA_TABLES)


#: runtime catalog of user-registered matrices (`ScoringMatrix.register`)
_REGISTERED: dict = {}

#: published families that cannot be bundled offline: their tables are
#: estimated directly from alignment corpora (Pfam seeds, structural
#: superpositions, ...) with no generative evolutionary chain to
#: re-derive them from, unlike PAM (Dayhoff chain) and VTML (VT chain).
#: `from_name` recognizes these prefixes and raises a targeted error
#: pointing at the `from_file`/`register` migration path.
_EXTERNAL_FAMILIES = ("PFASUM", "GONNET", "MIQS", "BENNER", "JOHNSON")


def _parse(table: str) -> np.ndarray:
    rows = [
        [float(x) for x in line.split()]
        for line in table.strip().splitlines()
    ]
    data = np.asarray(rows, dtype=np.float32)
    if data.shape[0] != data.shape[1]:
        raise ValueError("substitution table is not square")
    return data


class ScoringMatrix:
    """A scoring matrix over an alphabet of symbols.

    Drop-in equivalent of ``scoring_matrices.ScoringMatrix`` for the
    subset of the API the aligner consumes (``lib.pyx:1199-1238``):
    ``from_name``, ``alphabet``, ``is_integer``, ``size`` plus equality
    and pickling, extended with array access for the TPU data path.
    """

    __slots__ = ("_data", "_alphabet", "_name")

    def __init__(self, data, alphabet: str = _PROTEIN_ALPHABET, name=None):
        arr = np.asarray(data, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
            raise ValueError("matrix data must be square")
        if arr.shape[0] != len(alphabet):
            raise ValueError(
                f"matrix size {arr.shape[0]} does not match alphabet "
                f"length {len(alphabet)}"
            )
        arr.setflags(write=False)
        self._data = arr
        self._alphabet = alphabet
        self._name = name

    # --- Constructors ------------------------------------------------------

    @classmethod
    def from_name(cls, name: str) -> "ScoringMatrix":
        """Load one of the bundled matrices by name.

        ``PAM`` names outside the transcribed anchor tables are
        generated from the fitted Dayhoff chain (see
        `ScoringMatrix.pam`): entries that fall within ~1e-4 of a
        rounding boundary are not pinned by the anchors and may differ
        by ±1 from NCBI's published files for those distances.

        Example:
            >>> m = ScoringMatrix.from_name("BLOSUM50")
            >>> m.name
            'BLOSUM50'

        """
        key = name.upper()
        if key in _REGISTERED:
            return _REGISTERED[key]
        if key in _TABLES:
            return cls(_parse(_TABLES[key]), _PROTEIN_ALPHABET, name=key)
        if key.startswith("PAM") and key[3:].isdigit():
            return cls.pam(int(key[3:]))
        if key.startswith("VTML") and key[4:].isdigit():
            return cls.vtml(int(key[4:]))
        # "PAM{n}/{d}" — the name `pam()` gives non-default-scale
        # tables, so their repr() round-trips
        if key.startswith("PAM") and key.count("/") == 1:
            n_s, d_s = key[3:].split("/")
            if n_s.isdigit() and d_s.isdigit():
                return cls.pam(int(n_s), int(d_s))
        for family in _EXTERNAL_FAMILIES:
            if key.startswith(family):
                raise ValueError(
                    f"matrix {name!r} is not bundled: the {family} "
                    f"family is estimated from alignment corpora and "
                    f"has no generative model to re-derive it from "
                    f"(unlike the PAM/VTML chains), so bundling it "
                    f"requires the published table.  Load it with "
                    f"ScoringMatrix.from_file(path) (NCBI/EMBOSS text "
                    f"format) and optionally "
                    f"ScoringMatrix.register(matrix, {name!r}) to make "
                    f"this name resolvable"
                )
        raise ValueError(
            f"unknown matrix name: {name!r} "
            f"(available: {', '.join(sorted(_TABLES))}, any PAM10..."
            f"PAM500, any VTML10...VTML500; load others with "
            f"ScoringMatrix.from_file and add them to the catalog with "
            f"ScoringMatrix.register)"
        )

    @classmethod
    def pam(cls, n: int, scale_denominator=None) -> "ScoringMatrix":
        """Generate the PAM-``n`` substitution matrix from the Dayhoff
        evolutionary chain.

        Scores are integer log-odds of the fitted 20-state reversible
        Markov chain (`pyopal_tpu._pam_chain`) raised to the ``n``-th
        power, in units of ``ln(2)/scale_denominator`` (bits divided by
        the denominator), with B/Z as frequency-weighted odds mixtures
        of {N,D}/{Q,E}, X as the frequency-weighted average score, and
        ``*`` the matrix minimum — the conventions recovered from the
        published NCBI tables, which this generator reproduces
        bit-exactly at n=30/70/120/250 (asserted by
        ``tests/test_matrices.py``).

        Args:
            n (`int`): PAM evolutionary distance, 1 to 500.
            scale_denominator (`int`, optional): score units as a
                fraction of a bit: 2 = half-bits, 3 = third-bits.
                Defaults to the published convention — 2 for
                ``n <= 170``, 3 above (matching the four NCBI anchor
                tables).  A handful of entries that fall within ~1e-4
                of a rounding boundary are not pinned by the anchors
                and may differ by ±1 from NCBI's files at other n.
                Non-default denominators are recorded in the matrix
                name as ``PAM{n}/{denominator}`` so the result is
                never mistaken for the canonical table.

        Example:
            >>> ScoringMatrix.pam(250) == ScoringMatrix.from_name("PAM250")
            True

        """
        n = operator.index(n)  # 250.0 must not silently truncate
        if not 1 <= n <= 500:
            raise ValueError(f"PAM distance out of range [1, 500]: {n}")
        default_denominator = 2 if n <= 170 else 3
        if scale_denominator is None:
            scale_denominator = default_denominator
        else:
            if scale_denominator != int(scale_denominator):
                raise ValueError(
                    f"scale_denominator must be an integer: "
                    f"{scale_denominator!r}"
                )
            scale_denominator = int(scale_denominator)
            if not 1 <= scale_denominator <= 8:
                raise ValueError(
                    f"scale_denominator out of range [1, 8]: "
                    f"{scale_denominator!r}"
                )
        # a non-default scale produces different data than the
        # canonical table of the same distance, so the deviation is
        # encoded in the name (e.g. "PAM250/2" for half-bit PAM250)
        if scale_denominator == default_denominator:
            key = f"PAM{n}"
        else:
            key = f"PAM{n}/{scale_denominator}"
        # published anchors are served from the transcribed tables so
        # boundary entries are exactly NCBI's even if float rounding
        # ever drifted
        if key in _TABLES and scale_denominator == default_denominator:
            return cls(_parse(_TABLES[key]), _PROTEIN_ALPHABET, name=key)
        from ._pam_chain import pam_scores

        lam = math.log(2.0) / scale_denominator
        return cls(pam_scores(n, lam), _PROTEIN_ALPHABET, name=key)

    @classmethod
    def vtml(cls, n: int) -> "ScoringMatrix":
        """Generate the VTML-``n`` substitution matrix from the fitted
        VT evolutionary chain.

        The VTML family (Mueller & Vingron 2000) is one continuous-time
        chain evaluated at different distances; this tree carries one
        published anchor, VTML80 (the table the reference's own test
        suite uses), and a reversible generator recovered from it by
        constrained fitting (`pyopal_tpu._vtml_chain`): the chain's
        exact distance-80 log-odds land in every VTML80 integer's
        rounding interval, so ``vtml(80)`` IS the bundled table.

        Matrices at other distances are this chain's extrapolations —
        the same construction the published family uses, from a chain
        consistent with the anchor — but with only one anchor
        available offline they are **not certified bit-equal** to
        Mueller-Vingron's own tables at those distances (entries near
        rounding boundaries may differ by ±1).  For certified tables,
        load the published file with `from_file` and `register` it.

        Args:
            n (`int`): VTML evolutionary distance, 1 to 500.

        Example:
            >>> ScoringMatrix.vtml(80) == ScoringMatrix.from_name("VTML80")
            True

        """
        n = operator.index(n)  # 80.0 must not bypass the anchor table
        if not 1 <= n <= 500:
            raise ValueError(f"VTML distance out of range [1, 500]: {n}")
        key = f"VTML{n}"
        # the anchor is served from the transcribed published table
        # (identical 20x20 block; its B/Z/X rows follow no derivable
        # rule, so the transcription is authoritative)
        if key in _TABLES:
            return cls(_parse(_TABLES[key]), _PROTEIN_ALPHABET, name=key)
        from ._vtml_chain import vtml_scores

        return cls(vtml_scores(n), _PROTEIN_ALPHABET, name=key)

    @classmethod
    def from_text(cls, text: str, name=None) -> "ScoringMatrix":
        """Parse a matrix in the standard NCBI/EMBOSS text format.

        The format used by BLAST ``-matrix`` files, EMBOSS data files
        and MMseqs2 ``.out`` matrices (e.g. ``VTML80.out``): ``#``
        comment lines, a header row of symbols, then one row per
        symbol, each led by its letter.  Asymmetric row/column symbol
        orders are rejected; the row-letter column is optional.

        Example:
            >>> m = ScoringMatrix.from_text('''
            ...    A  C
            ... A  1 -2
            ... C -2  1
            ... ''')
            >>> m.alphabet
            'AC'

        """
        lines = [
            ln
            for ln in (raw.strip() for raw in text.splitlines())
            if ln and not ln.startswith("#")
        ]
        if not lines:
            raise ValueError("empty matrix text")
        header = lines[0].split()
        if any(len(tok) != 1 or tok.isdigit() for tok in header):
            raise ValueError(
                "matrix text must start with a symbol header row"
            )
        alphabet = "".join(header)
        n = len(header)
        rows = []
        row_letters = []
        for ln in lines[1:]:
            toks = ln.split()
            if len(toks) == n + 1:
                row_letters.append(toks[0])
                toks = toks[1:]
            elif len(toks) != n:
                raise ValueError(f"matrix row has {len(toks)} fields, expected {n}")
            rows.append([float(t) for t in toks])
        if row_letters and "".join(row_letters) != alphabet:
            raise ValueError(
                "row symbols do not match the header symbol order"
            )
        if len(rows) != n:
            raise ValueError(
                f"matrix has {len(rows)} rows for {n} symbols"
            )
        return cls(np.asarray(rows, np.float32), alphabet, name=name)

    @classmethod
    def from_file(cls, path) -> "ScoringMatrix":
        """Load a matrix file in the NCBI/EMBOSS text format.

        The migration path for named matrices not bundled here (the
        reference rides the external ``scoring-matrices`` catalog,
        upstream PyOpal ``pyproject.toml:44-46``): download the table
        (e.g. MMseqs2's ``VTML160.out``) and load it directly, or
        `register` it to make `from_name` find it.
        """
        import os

        with open(path) as f:
            text = f.read()
        name = os.path.splitext(os.path.basename(path))[0].upper()
        return cls.from_text(text, name=name)

    @classmethod
    def register(cls, matrix: "ScoringMatrix", name=None) -> None:
        """Add ``matrix`` to the runtime catalog under ``name``.

        Later `from_name` calls (including ``Aligner(scoring_matrix=
        "<name>")``) resolve it; bundled names cannot be shadowed.
        """
        key = (name or matrix.name or "").upper()
        if not key:
            raise ValueError("matrix has no name to register under")
        if key in _TABLES:
            raise ValueError(f"cannot shadow the bundled matrix {key!r}")
        _REGISTERED[key] = ScoringMatrix(
            matrix.data, matrix.alphabet, name=key
        )

    def to_text(self) -> str:
        """Render the matrix in the NCBI/EMBOSS text format
        (round-trips through `from_text`)."""
        # width leaves >= 2 spaces before the widest value so the row
        # letter never abuts the first field once one column is eaten
        # by the letter itself
        width = max(
            4, max(len(f"{v:g}") for v in self._data.reshape(-1)) + 2
        )
        out = ["".join(f"{c:>{width}}" for c in self._alphabet)]
        for letter, row in zip(self._alphabet, self._data):
            out.append(
                letter + "".join(f"{v:>{width}g}" for v in row)[1:]
            )
        return "\n".join(out) + "\n"

    @classmethod
    def from_match_mismatch(
        cls,
        match: float = 1.0,
        mismatch: float = -1.0,
        alphabet: str = "ACGT",
    ) -> "ScoringMatrix":
        """Create a matrix from uniform match/mismatch scores."""
        n = len(alphabet)
        data = np.full((n, n), mismatch, dtype=np.float32)
        np.fill_diagonal(data, match)
        return cls(data, alphabet)

    @classmethod
    def from_diagonal(
        cls,
        diagonal,
        mismatch: float = 0.0,
        alphabet: str = _PROTEIN_ALPHABET,
    ) -> "ScoringMatrix":
        """Create a matrix with per-symbol diagonal scores."""
        diag = np.asarray(list(diagonal), dtype=np.float32)
        n = len(alphabet)
        if diag.shape[0] != n:
            raise ValueError("diagonal length does not match alphabet")
        data = np.full((n, n), mismatch, dtype=np.float32)
        np.fill_diagonal(data, diag)
        return cls(data, alphabet)

    @classmethod
    def available_matrices(cls):
        """Names of all bundled matrices."""
        return sorted(_TABLES)

    # --- Accessors ----------------------------------------------------------

    @property
    def name(self):
        """`str` or `None`: The name of the matrix, if any."""
        return self._name

    @property
    def alphabet(self) -> str:
        """`str`: The alphabet of the matrix columns/rows."""
        return self._alphabet

    @property
    def data(self) -> np.ndarray:
        """`numpy.ndarray`: The raw (read-only) matrix data."""
        return self._data

    def is_integer(self) -> bool:
        """Check whether every score is an integer."""
        return bool(np.equal(np.mod(self._data, 1.0), 0.0).all())

    def is_symmetric(self) -> bool:
        """Check whether the matrix is symmetric."""
        return bool(np.array_equal(self._data, self._data.T))

    def size(self) -> int:
        """The number of rows/columns in the matrix."""
        return self._data.shape[0]

    def int_data(self) -> np.ndarray:
        """The matrix as an ``int32`` array (requires `is_integer`)."""
        if not self.is_integer():
            raise ValueError("Integer scoring matrix is expected")
        return self._data.astype(np.int32)

    def __getitem__(self, index):
        return self._data[index]

    def __eq__(self, other) -> bool:
        if not isinstance(other, ScoringMatrix):
            return NotImplemented
        return self._alphabet == other._alphabet and np.array_equal(
            self._data, other._data
        )

    def __hash__(self) -> int:
        return hash((ScoringMatrix, self._alphabet, self._data.tobytes()))

    def __reduce__(self):
        return (
            ScoringMatrix,
            (self._data.tolist(), self._alphabet, self._name),
        )

    def __repr__(self) -> str:
        if self._name is not None:
            return f"ScoringMatrix.from_name({self._name!r})"
        return (
            f"ScoringMatrix({self._data.tolist()!r}, {self._alphabet!r})"
        )
