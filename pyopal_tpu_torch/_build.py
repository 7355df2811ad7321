"""Where the port puts the libraries it compiles at run time.

The CUDA kernels (`pyopal_tpu_torch.ops._cuda`) and the C codec and
result types (`pyopal_tpu_torch.native`) build at first use into
``build/pyopal_tpu_torch/`` at the repository root when the package runs
from a writable checkout, and into ``pyopal_tpu_torch/`` under the
user's cache directory (``$XDG_CACHE_HOME`` or ``~/.cache``) when it is
installed.
"""

from __future__ import annotations

import os
from pathlib import Path


def checkout_root() -> Path | None:
    """The repository root when the package runs from a writable source
    checkout, else None."""
    root = Path(__file__).resolve().parents[1]
    if (root / "pyproject.toml").is_file() and os.access(root, os.W_OK):
        return root
    return None


def build_dir() -> Path:
    root = checkout_root()
    if root is not None:
        return root / "build" / "pyopal_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "pyopal_tpu_torch"
