"""Compute engines for the database search (port of ``pyopal_tpu/ops``).

- `naive`  — scalar numpy oracle; ground truth.
- `sweep`  — int32 column sweep in plain PyTorch (port of ``xla.py``).
- `ragged` — kernels K1 (``csrc/ragged.cu``), K4 (``csrc/ragged_v1.cu``)
  and K5 (``csrc/ragged_strip.cu``), routed by ``safe_pad`` and mode as
  the reference routes them, and their plain versions.
- `q8`     — kernels K2 (``csrc/q8.cu``) and the packed walk
  (``csrc/q8_narrow.cu``), which serves K7, the narrow pass, and K2's
  exact route in sw score mode, and their plain versions.
- `ragged_long` — kernel K3 (``csrc/ragged_long.cu``), the segmented
  search of one long query, and its plain version.
- `group`  — kernel K6 (``csrc/group.cu``), one query over a stacked
  group of the grouped layout, and its plain version.
- `traceback` — full mode's kernels T1, the direction pass
  (``csrc/traceback_dirs.cu``), and T2, the walk
  (``csrc/traceback_walk.cu``), their plain versions and the batching.
- `engine` — routing, launches and result assembly.

`packing` builds the flat and grouped layouts the kernels read; `_cuda` builds and
binds the kernels.
"""
