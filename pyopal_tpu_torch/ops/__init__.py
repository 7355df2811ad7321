"""Compute engines for the database search (port of ``pyopal_tpu/ops``).

- `naive`  — scalar numpy oracle; ground truth.
- `sweep`  — int32 column sweep in plain PyTorch (port of ``xla.py``).
- `ragged` — kernel K1 (``csrc/ragged.cu``) and its plain version.
- `q8`     — kernel K2 (``csrc/q8.cu``) and its plain version.
- `engine` — routing, launches and result assembly.

`packing` builds the flat layout both kernels read; `_cuda` builds and
binds the kernels.
"""
