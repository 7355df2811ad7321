"""Time K2's two walks, int32 and packed, on the q8 groups of each tier.

Usage (on a machine with a CUDA card)::

    python3 tools/q8_packed_timing.py [--reps N] [--out FILE]

On the main database of ``chip_smoke.main_workload`` (12,071 sequences,
4,683,440 residues), for each q8 tier (64, 128, 256, 512 and 1024):
eight groups of eight queries of the tier (lengths in (tier / 2, tier],
at 256 also eight groups of 256 residues, the ``batch256`` cell's), at
the engine's lane width for the tier, BLOSUM50, gaps 3/1, sw score mode.
Each group set runs K2's int32 walk (``search_flat_q8``) and its packed
walk (``packed_cap`` = Q_pad x max |S|, the engine's route), checks
that all three planes are equal bit for bit and that each call made the
launches it should, then times both by CUDA events, ``--reps`` calls of
each in the order int32, packed, packed, int32.  It then checks the
packed walk at the largest cap the engine admits at 256 and 512 rows
(BLOSUM50 times 8 and times 4: caps 30,720, with queries that are
stretches of database sequences, so that scores run into the
thousands), and that K7 (``narrow=True``) still returns min(K2, 255).
Prints one JSON line per measurement, with the card's name and power
limit, and the ptxas summary of both kernels' builds; ends with
``{"ok": true}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke
    import pyopal_tpu_torch as pt
    from pyopal_tpu_torch.ops import _cuda, engine, packing, q8

    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    card = _card()
    dev = torch.device("cuda")
    _cuda.build_all(["q8", "q8_narrow"])
    emit({"phase": "build", "card": card,
          "ptxas": {k: chip_smoke.ptxas_summary(v)
                    for k, v in _cuda.build_logs.items()}})

    db_seqs, _ = chip_smoke.main_workload()
    db = pt.Database(db_seqs)
    n_t = len(db)
    residues = db.total_length
    lengths = np.asarray(db.get_lengths())
    S = pt.ScoringMatrix.from_name("BLOSUM50").int_data()
    m_abs = int(np.abs(S).max())
    rng = np.random.default_rng(16)
    packs = {}

    def flat(lanes):
        if lanes not in packs:
            fp = packing.pack_database_slice_flat(db, 0, n_t, lanes=lanes)
            packs[lanes] = (fp, engine._flat_device(fp, dev)[:5])
        return packs[lanes]

    def inputs(queries, matrix, lanes):
        groups = [list(range(k, min(k + q8.QB, len(queries))))
                  for k in range(0, len(queries), q8.QB)]
        arrays = q8.make_profiles_q8_host(queries, matrix, groups,
                                          lanes=lanes)
        return tuple(torch.from_numpy(a).to(dev) for a in arrays)

    def call(base, fp_dev, chunk, **kw):
        return q8.search_flat_q8(*base, *fp_dev, 3, 1, "sw", False,
                                 chunk=chunk, **kw)

    def checked(label, base, fp, fp_dev, cap):
        """K2 and the packed walk once each: equal, one launch each."""
        before = dict(q8.launches)
        k2 = call(base, fp_dev, fp.chunk)
        pk = call(base, fp_dev, fp.chunk, packed_cap=cap)
        torch.cuda.synchronize()
        made = {k: v - before[k] for k, v in q8.launches.items()}
        equal = all(torch.equal(a, b) for a, b in zip(k2, pk))
        if not equal:
            raise SystemExit(f"q8_packed_timing: {label}: packed != K2")
        return k2, made

    def timed(fn, reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    cases = [(t, f"tier{t}", None) for t in (64, 128, 256, 512, 1024)]
    cases.insert(3, (256, "batch256", 256))
    for tier, label, fixed in cases:
        lanes = engine._Q8_LANES_BY_TIER.get(tier, 256)
        fp, fp_dev = flat(lanes)
        qls = ([fixed] * 64 if fixed else
               sorted(rng.integers(tier // 2 + 1, tier + 1, 64).tolist(),
                      reverse=True))
        queries = [rng.integers(0, 20, n).astype(np.uint8) for n in qls]
        base = inputs(queries, S, lanes)
        cap = tier * m_abs
        admitted = engine._packed_exact_domain("sw", False, 3, 1, m_abs, tier)
        k2, made = checked(label, base, fp, fp_dev, cap)
        ms = {"int32": [], "packed": []}
        for walk in ("int32", "packed", "packed", "int32"):
            kw = {} if walk == "int32" else {"packed_cap": cap}
            call(base, fp_dev, fp.chunk, **kw)  # warm
            ms[walk].append(timed(lambda: call(base, fp_dev, fp.chunk, **kw),
                                  args.reps))
        cells = sum(qls) * residues
        walked_rows = sum(max(a, b) for a, b in zip(qls[::2], qls[1::2]))
        emit({"phase": "tier", "label": label, "tier": tier, "lanes": lanes,
              "queries": len(qls), "query_rows": sum(qls),
              "pair_rows": 2 * walked_rows, "cells": cells,
              "cap": cap, "admitted": admitted, "equal": True,
              "launches": made, "max_score": int(k2[0].max()),
              "int32_ms": ms["int32"], "packed_ms": ms["packed"],
              "int32_gcups": cells / (min(ms["int32"]) * 1e-3) / 1e9,
              "packed_gcups": cells / (min(ms["packed"]) * 1e-3) / 1e9,
              "speedup": min(ms["int32"]) / min(ms["packed"]),
              "card": card})
        if label == "batch256":  # K7 on the same groups: min(K2, 255)
            before = q8.launches["q8_narrow"]
            k7 = call(base, fp_dev, fp.chunk, narrow=True)
            ok = (torch.equal(k7[0], k2[0].clamp(max=q8.NARROW_CAP))
                  and q8.launches["q8_narrow"] == before + 1)
            if not ok:
                raise SystemExit("q8_packed_timing: K7 is not min(K2, 255)")
            emit({"phase": "k7", "equal_min_k2_255": True,
                  "flagged": int((k7[0] == q8.NARROW_CAP).sum())})

    # the largest admitted cap: BLOSUM50 x 8 at 256 rows, x 4 at 512
    long_ids = np.nonzero(lengths >= 600)[0]
    for tier, scale in ((256, 8), (512, 4)):
        big = S * scale
        cap = tier * int(np.abs(big).max())
        if not engine._packed_exact_domain("sw", False, 3, 1,
                                           int(np.abs(big).max()), tier):
            raise SystemExit(f"q8_packed_timing: cap {cap} not admitted")
        lanes = engine._Q8_LANES_BY_TIER[tier]
        fp, fp_dev = flat(lanes)
        queries = [db.get_encoded(int(long_ids[k]))[:tier - k].copy()
                   for k in range(16)]
        base = inputs(queries, big, lanes)
        k2, made = checked(f"cap {cap}", base, fp, fp_dev, cap)
        emit({"phase": "largest_cap", "tier": tier, "scale": scale,
              "cap": cap, "equal": True, "launches": made,
              "max_score": int(k2[0].max())})
    emit({"ok": True, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
