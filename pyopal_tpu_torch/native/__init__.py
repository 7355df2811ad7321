"""Native (CPython C API) extensions: sequence codec + result types.

Port of ``pyopal_tpu/native``, built from this package's own copies of
the C sources.  The searches run on the GPU; these extensions cover the
two serial host-side hot loops outside the kernels, where upstream
PyOpal is likewise native (Cython):

- ``_encoder`` (``encoder.c``): ASCII->ordinal encoding and FASTA
  parsing (upstream analog: ``Alphabet.encode_into``,
  ``lib.pyx:239-268``);
- ``_results`` (``results.c``): the result extension types and the bulk
  builders that wrap the kernels' dense score/end arrays (upstream
  analog: preallocated cdef results, ``platform/pyx.in:64-72``).

`ensure_built` (called by the package's ``__init__`` before any
submodule binds them) compiles each source with the host's C compiler
(``sysconfig``'s ``CC``, ``-O3 -shared -fPIC``) into ``native/`` under
`pyopal_tpu_torch._build.build_dir`, one library per source named by a
hash of the source and the command, and loads it as
``pyopal_tpu_torch.native._encoder`` / ``._results``.  An installed
package whose wheel built them in place loads those instead.  Both are
optional: the pure-Python fallbacks give the same results, and
``PYOPAL_TPU_NO_BUILD=1`` keeps the compiler from running.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.machinery
import importlib.util
import os
import shlex
import subprocess
import sys
import sysconfig
from pathlib import Path

from .._build import build_dir, checkout_root

_EXTENSIONS = ("_encoder", "_results")
_SOURCES = {"_encoder": "encoder.c", "_results": "results.c"}
HERE = Path(__file__).resolve().parent
BUILD_DIR = build_dir() / "native"
CFLAGS = ["-O3", "-shared", "-fPIC"]


def _missing_extensions() -> list:
    missing = []
    for name in _EXTENSIONS:
        try:
            importlib.import_module(f"{__name__}.{name}")
        except ImportError:
            missing.append(name)
    return missing


def _compile_command(name: str, out) -> list:
    cc = shlex.split(sysconfig.get_config_var("CC") or "cc")
    paths = sysconfig.get_paths()
    includes = dict.fromkeys((paths["include"], paths["platinclude"]))
    return [*cc, *CFLAGS, *(f"-I{d}" for d in includes), "-o", str(out),
            str(HERE / _SOURCES[name])]


def _library_path(name: str) -> Path:
    """Where the library of extension ``name`` is (or will be) built."""
    h = hashlib.sha256((HERE / _SOURCES[name]).read_bytes())
    h.update(" ".join(_compile_command(name, "")).encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}{suffix}"


def _build(name: str, quiet: bool) -> Path:
    """The library of ``name``, compiled first where it is missing."""
    lib = _library_path(name)
    if lib.exists():
        return lib
    if os.environ.get("PYOPAL_TPU_NO_BUILD"):
        raise ImportError(f"{name} is not built and PYOPAL_TPU_NO_BUILD is set")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # serialize concurrent builds (e.g. pytest-xdist workers importing
    # at once): whoever loses the race blocks until the winner finishes,
    # then finds the library in place
    with open(BUILD_DIR / ".lock", "a+") as lock_file:
        try:
            import fcntl

            fcntl.flock(lock_file, fcntl.LOCK_EX)
        except ImportError:  # pragma: no cover - non-POSIX
            pass
        if not lib.exists():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            try:
                subprocess.run(_compile_command(name, tmp), check=True,
                               capture_output=quiet)
                os.replace(tmp, lib)
            finally:
                tmp.unlink(missing_ok=True)
    return lib


def _load(name: str, lib: Path) -> None:
    """Load ``lib`` as ``pyopal_tpu_torch.native.<name>`` and register
    it, so that ``__module__``, pickling and a plain import resolve."""
    full = f"{__name__}.{name}"
    loader = importlib.machinery.ExtensionFileLoader(full, str(lib))
    spec = importlib.util.spec_from_file_location(full, lib, loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    sys.modules[full] = module
    setattr(sys.modules[__name__], name, module)


def ensure_built(quiet: bool = True) -> bool:
    """Build and load any native extension not loaded yet.

    A source checkout always loads the libraries built from its sources
    (``setup.py build_ext --inplace`` may leave older modules beside
    them); an installed package first imports the modules its wheel
    built in place.  Returns `True` when every extension is importable
    afterwards; `False` when a build or load failed (no compiler, or
    ``PYOPAL_TPU_NO_BUILD=1`` and nothing built yet).
    """
    missing = [n for n in _EXTENSIONS if f"{__name__}.{n}" not in sys.modules]
    if missing and checkout_root() is None:
        missing = _missing_extensions()
    try:
        for name in missing:
            _load(name, _build(name, quiet))
    except (OSError, subprocess.CalledProcessError, ImportError):
        return False
    return True
