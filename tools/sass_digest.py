"""Digest the SASS of built kernel libraries, function by function.

Usage::

    python3 tools/sass_digest.py LIB.so [LIB.so ...]

For each library (a ``build/pyopal_tpu_torch/<kernel>-<hash>.so`` that
``pyopal_tpu_torch.ops._cuda`` built), runs ``cuobjdump -sass`` and
prints one JSON line: per kernel function, its instruction count, a
SHA-256 of its instructions with addresses and encodings stripped, and
the count of each opcode with its modifiers (``VIADDMNMX.S16x2``, say:
which instructions a source line became).  Two builds of one source from
two trees compile to the same machine code exactly when their digests
agree.  Needs the CUDA toolkit's ``cuobjdump`` (on the PATH or under
``/usr/local/cuda/bin``).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

_FUNC = re.compile(r"^\s*Function : (\S+)")
# "/*0070*/  IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;  /* 0x... */"
_INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")


def _cuobjdump() -> str:
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(path):
        raise SystemExit("cuobjdump not found: needs the CUDA toolkit")
    return path


def digest(lib: str) -> dict:
    """``{function: {"instructions": n, "sha256": hex, "opcodes": {opcode:
    n}}}`` of one library."""
    out = subprocess.run(
        [_cuobjdump(), "-sass", lib], check=True, capture_output=True,
        text=True,
    ).stdout
    funcs: dict = {}
    name = None
    for line in out.splitlines():
        m = _FUNC.match(line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = _INSN.match(line)
        if m and name is not None:
            funcs[name].append(m.group(1))
    out = {}
    for f, ins in sorted(funcs.items()):
        # the mnemonic after any predicate ("@!P0 BRA ...")
        ops = [i.split()[1] if i.startswith("@") else i.split()[0]
               for i in ins if i.split()]
        out[f] = {"instructions": len(ins),
                  "sha256": hashlib.sha256("\n".join(ins).encode()).hexdigest(),
                  "opcodes": dict(sorted((o, ops.count(o)) for o in set(ops)))}
    return out


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for lib in argv:
        print(json.dumps({"library": lib, "functions": digest(lib)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
