"""Time one 256-aa `Aligner.align` of the main path, and its parts.

Usage (on a machine with a CUDA card)::

    python3 tools/align_timing.py [TREE ...]

For each TREE (a checkout of this repository; default: the one holding
this script), starts a fresh process that imports that tree's
``pyopal_tpu_torch`` and ``chip_smoke.main_workload`` (the main
database: 12,071 sequences, 4,683,440 residues), and times
``Aligner.align(queries[0], db, mode=...)`` in score and end modes (sw,
BLOSUM50, gaps 3/1), ``CALLS`` calls each after a warm-up: the call by
the host clock, K1 by CUDA events around its launch
(``ops._cuda.launch``), the result building (the engine's
``build_score_results`` / ``build_end_results``) by the host clock, and
the rest of the call.  Prints one JSON line per tree, with the card's
name and power limit and the module of the result objects.  Trees run
one after the other in one call, so that two versions compare on one
card: run ``parent final final parent``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 20


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def time_tree(tree):
    """The JSON line of one tree (run in a process of its own)."""
    import torch

    sys.path.insert(0, tree)
    import chip_smoke
    import pyopal_tpu_torch as pt
    from pyopal_tpu_torch.ops import _cuda, engine

    db_seqs, queries = chip_smoke.main_workload()
    db = pt.Database(db_seqs)
    al = pt.Aligner(device="cuda")
    out = {"tree": tree, "card": _card(), "calls": CALLS}
    real_launch = _cuda.launch
    for mode in ("score", "end"):
        hits = al.align(queries[0], db, mode=mode)  # builds, packs, warms
        builder = f"build_{mode}_results"
        real_build = getattr(engine, builder)
        events, build_s, call_s = [], [], []

        def launch(name, *args):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            real_launch(name, *args)
            stop.record()
            events.append((name, start, stop))

        def build(*args):
            t0 = time.perf_counter()
            res = real_build(*args)
            build_s.append(time.perf_counter() - t0)
            return res

        _cuda.launch = launch
        setattr(engine, builder, build)
        try:
            for _ in range(CALLS):
                t0 = time.perf_counter()
                al.align(queries[0], db, mode=mode)
                call_s.append(time.perf_counter() - t0)
        finally:
            _cuda.launch = real_launch
            setattr(engine, builder, real_build)
        torch.cuda.synchronize()
        if [e[0] for e in events] != ["ragged"] * CALLS:
            raise SystemExit(f"launches: {[e[0] for e in events]}")
        k1_s = [a.elapsed_time(b) * 1e-3 for _, a, b in events]
        out[mode] = {
            "call_ms": [t * 1e3 for t in call_s],
            "k1_ms": [t * 1e3 for t in k1_s],
            "build_ms": [t * 1e3 for t in build_s],
            "rest_ms": [(c - k - b) * 1e3
                        for c, k, b in zip(call_s, k1_s, build_s)],
            "result_type": f"{type(hits[0]).__module__}."
                           f"{type(hits[0]).__name__}",
            "hits": len(hits),
        }
    return out


def main(argv) -> int:
    if argv[:1] == ["--tree"]:
        print(json.dumps(time_tree(argv[1])), flush=True)
        return 0
    for tree in map(os.path.abspath, argv or [HERE]):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", tree],
            cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
