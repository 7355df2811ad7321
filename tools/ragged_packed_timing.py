"""Time K1's two walks, int32 and packed, per tier, alone and in cohorts.

Usage (on a machine with a CUDA card)::

    python3 tools/ragged_packed_timing.py [--reps N] [--out FILE]

Two databases: the benchmark's ``swissprot-blosum62`` configuration
(405,506 sequences, 146,166,984 residues, its lengths from
``benchmark/generate.py``, residues uniform from a fixed seed; BLOSUM62,
gaps 12/2) and ``chip_smoke.main_workload``'s 12,071 sequences
(4,683,440 residues; BLOSUM50, gaps 3/1).  For each K1 tier, 64 to
4096, and the fine tier 5,120: one query of three quarters of the tier
and a cohort of four (the fine tier, a query of 5,000 residues, takes
one), each holding a stretch of a database sequence.  Each case runs
K1's int32 walk (``ragged.search_flat``) and its packed route (H's cap
at min(Q_pad, T_max) x max |S|, skipped where the engine's int16 bound
refuses it; ``routed`` says whether ``engine._ragged_packed_cap`` takes
it, which also asks for a wave of blocks), checks that all three planes are
equal bit for bit and that each launched its kernel (several launches
where its pass buffer passes ``SCRATCH_BYTES``), then times both by
CUDA events, ``--reps`` calls of each in the order int32, packed,
packed, int32.  Prints one JSON line per case, with the launch's blocks
on each walk, the card's name and power limit, and the ptxas summary of
both kernels' builds; ends with ``{"ok": true}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

TIERS = (64, 128, 256, 512, 1024, 2048, 4096, 5120)


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke
    import pyopal_tpu_torch as pt
    from benchmark import generate
    from pyopal_tpu_torch.ops import _cuda, engine, packing, ragged

    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    card = _card()
    dev = torch.device("cuda")
    _cuda.build_all(["ragged", "ragged_packed"])
    emit({"phase": "build", "card": card,
          "ptxas": {k: chip_smoke.ptxas_summary(v)
                    for k, v in _cuda.build_logs.items()}})

    def swissprot():
        with open(os.path.join(HERE, "benchmark", "configs",
                               "swissprot-blosum62.json")) as f:
            config = json.load(f)
        lengths = generate.database_lengths(config["database"])
        codes = generate.database_codes(int(lengths.sum()), 19, dev)
        letters = config["scoring"]["letters"]
        return (generate.ascii_sequences(codes, lengths, letters), "BLOSUM62",
                12, 2)

    def sprot12071():
        seqs, _ = chip_smoke.main_workload()
        return seqs, "BLOSUM50", 3, 1

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

    rng = np.random.default_rng(19)
    for name, make in (("swissprot", swissprot), ("sprot12071", sprot12071)):
        seqs, matrix_name, go, ge = make()
        db = pt.Database(seqs)
        del seqs
        n_t = len(db)
        fp = packing.pack_database_slice_flat(db, 0, n_t)
        fp_dev = engine._flat_device(fp, dev)[:5]
        S = pt.ScoringMatrix.from_name(matrix_name).int_data()
        m_abs = int(np.abs(S).max())
        t_max = engine._slice_maxlen(db, 0, n_t)
        residues = db.total_length
        lanes = fp.lengths.size
        long_ids = np.nonzero(np.asarray(db.get_lengths()) >= 600)[0]
        emit({"phase": "database", "name": name, "targets": n_t,
              "residues": residues, "lanes": lanes, "t_max": t_max,
              "matrix": matrix_name, "gaps": [go, ge], "card": card})
        for tier in TIERS:
            fine = tier == TIERS[-1]
            for n_q in (1,) if fine else (1, 4):
                qls = [5000] if fine else [tier * 3 // 4] * n_q
                queries = []
                for k, n in enumerate(qls):
                    q = rng.integers(0, 20, n).astype(np.uint8)
                    hit = db.get_encoded(int(long_ids[k]))[:min(n, 600)]
                    q[:len(hit)] = hit
                    queries.append(q)
                profs = torch.from_numpy(ragged.make_profiles_host(
                    queries, S, q_pad=tier if fine else None)).to(dev)
                qlens = torch.tensor(qls, dtype=torch.int32, device=dev)
                rows = min(tier, t_max)
                cap = (rows * m_abs if engine._packed_exact_domain(
                    "sw", False, go, ge, m_abs, rows) else None)
                routed = engine._ragged_packed_cap(
                    "sw", False, go, ge, m_abs, tier, t_max, True, n_q,
                    lanes) is not None
                call = (profs, qlens, *fp_dev, go, ge, "sw", False, fp.chunk,
                        True)
                row = {"phase": "tier", "db": name, "tier": tier,
                       "queries": n_q, "query_rows": sum(qls), "cap": cap,
                       "routed": routed, "card": card}
                if cap is None:
                    emit({**row, "admitted": False})
                    continue
                before = dict(ragged.launches)
                wide = ragged.search_flat(*call)
                packed = ragged.search_flat(*call, packed_cap=cap)
                torch.cuda.synchronize()
                made = {k: v - before[k] for k, v in ragged.launches.items()
                        if v != before[k]}
                if sorted(made) != ["ragged", "ragged_packed"]:
                    raise SystemExit(f"{name} tier {tier}: launches {made}")
                if not all(torch.equal(a, b) for a, b in zip(wide, packed)):
                    raise SystemExit(f"{name} tier {tier} x {n_q}: packed "
                                     "differs from K1's int32 walk")
                ms = {"int32": [], "packed": []}
                for walk in ("int32", "packed", "packed", "int32"):
                    kw = {} if walk == "int32" else {"packed_cap": cap}
                    ms[walk].append(timed(
                        lambda: ragged.search_flat(*call, **kw), args.reps))
                cells = sum(qls) * residues
                per_block = 256 // ragged.wave_group(tier)
                emit({**row, "admitted": True, "equal": True,
                      "max_score": int(wide[0].max()), "launches": made,
                      "blocks_int32": -(-lanes // per_block) * n_q,
                      "blocks_packed": -(-lanes // (2 * per_block)) * n_q,
                      "int32_ms": ms["int32"], "packed_ms": ms["packed"],
                      "int32_gcups": cells / (min(ms["int32"]) * 1e-3) / 1e9,
                      "packed_gcups":
                          cells / (min(ms["packed"]) * 1e-3) / 1e9,
                      "speedup": min(ms["int32"]) / min(ms["packed"])})
        del db, fp, fp_dev
        torch.cuda.empty_cache()
    emit({"ok": True, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
