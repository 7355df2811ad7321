#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (the first failure ends the run with a nonzero exit code):

1. the card: name and power limit from ``nvidia-smi``, torch and CUDA
   versions;
2. the build: both kernels (``pyopal_tpu_torch/csrc/ragged.cu``,
   ``q8.cu``) compiled with ``nvcc`` for ``sm_90a``, in parallel;
3. each kernel against its plain PyTorch version on the card: all four
   algorithms in score and end modes at several query tiers, with edge
   target lengths and a 2500-residue self-hit (score > 12000), and calls
   that a small scratch budget splits into several launches;
4. the golden values through `pyopal_tpu_torch.Aligner` on ``cuda``;
5. the main path at full size: a synthetic 12,071-sequence database
   (the generator of ``bench.py``, seed 12071) searched with 67
   queries of 256 residues (8 full q8 groups + 3 leftovers) through
   ``Aligner.align_arrays`` in ``sw`` score and end modes and one
   ``Aligner.align``, with the launch counters set to 0 just before and
   read just after; a seeded sample of the results is checked against
   the scalar oracle, and nw/hw/ov end mode on a 1,000-target slice too;
6. timings with CUDA events after a warm-up, each kernel held against
   its plain version at the main path's shapes, the bound of each
   kernel, end-to-end throughput, and each kernel's launches in one
   ``align_arrays`` and one ``align`` call, counted;
7. the ``kernels`` line, then the card line, then the result line.

Every number printed is measured in this run on this card; the card's
name and power limit stand beside each timing.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

GO, GE = 3, 1
#: int32 operations per DP cell of sw score mode, counted from the
#: recurrence at its least: G = H - go (1 subtraction, shared by the next
#: column's E and the next row's F), E = max(G, E - ge) (2), F = max(G,
#: F - ge) (2), diagonal max(H + s, E) (2), clamp at 0 (1), H = max with
#: F (1), running best (1).  Hopper's fused add-max (DPX) instructions
#: could cut this further; their rate is not in the card's published
#: peaks, so the bound counts plain int32 operations.
OPS_PER_CELL_SW_SCORE = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT32_LANES_PER_SM = 64
N_SMS = 132


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def build_database(rng, n=12071, mean_len=350):
    """Synthetic Swiss-Prot-scale protein database (``bench.py``)."""
    letters = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", dtype=np.uint8)
    lengths = np.clip(
        rng.lognormal(np.log(mean_len), 0.45, n).astype(int), 30, 4000
    )
    seqs = []
    for L in lengths:
        seqs.append(letters[rng.integers(0, 20, L)].tobytes().decode("ascii"))
    return seqs


def smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0].strip()


def main():
    """Run every phase on the first CUDA card; returns the exit code."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import pyopal_tpu_torch as pt
    from pyopal_tpu_torch.ops import _cuda, engine, naive, packing, q8
    from pyopal_tpu_torch.ops import ragged, sweep

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # --- 1. the card --------------------------------------------------------
    card_line = smi("name,power.limit")
    card = {"card": card_line}
    max_sm_mhz = float(smi("clocks.max.sm").split()[0])
    emit({
        "phase": "card", **card,
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "clocks_max_sm_mhz": max_sm_mhz,
    })

    # --- 2. the build ------------------------------------------------------
    t0 = time.perf_counter()
    secs = _cuda.build_all()
    emit({
        "phase": "build", "nvcc_flags": _cuda.NVCC_FLAGS,
        "seconds_per_kernel": secs,
        "seconds": time.perf_counter() - t0,
        "libraries": sorted(p.name for p in _cuda.BUILD_DIR.glob("*.so")),
        "ptxas": {k: [ln for ln in v.splitlines() if "registers" in ln]
                  for k, v in _cuda.build_logs.items()},
    })

    S = pt.ScoringMatrix.from_name("BLOSUM50").int_data()
    algos = ("sw", "nw", "hw", "ov")

    def dev_flat(fp):
        return engine._flat_device(fp, dev)[:5]

    def compare(name, kernel, plain, args, label):
        ko = kernel(*args)
        torch.cuda.synchronize()
        po = plain(*args)
        torch.cuda.synchronize()
        err = max(int((k.long() - p.long()).abs().max()) for k, p in
                  zip(ko, po)) if ko[0].numel() else 0
        if err != 0 or any(k.shape != p.shape for k, p in zip(ko, po)):
            fail(f"{name} differs from its plain version at {label}: {err}")
        return ko, err

    # --- 3. kernels against their plain versions ----------------------------
    rng = np.random.default_rng(7)
    lens = [0, 1, 63, 64, 65, 127, 128, 129] + list(rng.integers(0, 600, 300))
    seqs = [rng.integers(0, 20, int(n)).astype(np.uint8) for n in lens]
    big = rng.integers(0, 20, 2500).astype(np.uint8)
    n_checked = 0
    t0 = time.perf_counter()
    fp128 = packing.pack_sequences_flat(seqs)
    fp_big = packing.pack_sequences_flat(seqs + [big])
    k1_cases = [
        ("tier64", [64, 40, 9], fp128),
        ("tier256", [256, 200, 129], fp128),
        ("tier1024", [1000, 700], fp128),
    ]
    split_cases = []  # (name, module, kernel, plain, args, unit rows, lanes)
    for label, qls, fp in k1_cases:
        queries = [rng.integers(0, 20, n).astype(np.uint8) for n in qls]
        profs = torch.from_numpy(ragged.make_profiles_host(queries, S)).to(dev)
        qlens = torch.tensor(qls, dtype=torch.int32, device=dev)
        for algo in algos:
            for ends in (False, True):
                args = (profs, qlens, *dev_flat(fp), GO, GE, algo, ends,
                        fp.chunk)
                compare("ragged", ragged.search_flat,
                        ragged.search_flat_reference, args,
                        f"{label} {algo} ends={ends}")
                n_checked += 1
        if label == "tier256":
            split_cases.append((
                "ragged", ragged, ragged.search_flat,
                ragged.search_flat_reference, args, profs.shape[1],
                fp.lengths.size))
    # the 2500-residue self-hit at the 4096 tier
    profs = torch.from_numpy(ragged.make_profiles_host([big], S)).to(dev)
    qlens = torch.tensor([2500], dtype=torch.int32, device=dev)
    for algo in algos:
        for ends in (False, True):
            out, _ = compare(
                "ragged", ragged.search_flat, ragged.search_flat_reference,
                (profs, qlens, *dev_flat(fp_big), GO, GE, algo, ends,
                 fp_big.chunk), f"tier4096 self-hit {algo} ends={ends}")
            n_checked += 1
            if algo == "sw":
                pos = int(fp_big.inv_pos[len(seqs)])
                self_score = int(out[0].reshape(-1)[pos])
                if self_score <= 12000:
                    fail(f"2500-aa self-hit scored {self_score}")
    k2_cases = [
        ("tier64", 512, [64, 1, 40, 63, 7, 50, 29, 33, 21, 3, 64, 12, 9, 17]),
        ("tier256", 512, [256, 129, 200, 255, 140, 180, 222, 250]),
        ("tier512", 256, [512, 257, 300, 400, 511, 260, 333, 444]),
    ]
    for label, lanes, qls in k2_cases:
        fp = packing.pack_sequences_flat(seqs, lanes=lanes)
        queries = [rng.integers(0, 20, n).astype(np.uint8) for n in qls]
        groups = q8.plan_groups(qls)
        arrays = q8.make_profiles_q8_host(queries, S, groups, lanes=lanes)
        profs, qv, maxq = (torch.from_numpy(a).to(dev) for a in arrays)
        for algo in algos:
            for ends in (False, True):
                args = (profs, qv, maxq, *dev_flat(fp), GO, GE, algo, ends,
                        fp.chunk)
                compare("q8", q8.search_flat_q8, q8.search_flat_q8_reference,
                        args, f"{label} {algo} ends={ends}")
                n_checked += 1
        if label == "tier64":  # two groups
            split_cases.append((
                "q8", q8, q8.search_flat_q8, q8.search_flat_q8_reference,
                args, profs.shape[1], fp.lengths.size))
    # calls split into several launches by a small scratch budget: one
    # unit (query or group) and 128 lanes per launch, or one unit and
    # every lane per launch
    budget = ragged.SCRATCH_BYTES
    split_launches = {}
    for name, mod, kfn, pfn, args, unit_rows, n_lanes in split_cases:
        for how, lanes_per_unit in (("lanes", 128), ("units", n_lanes)):
            ragged.SCRATCH_BYTES = 8 * unit_rows * lanes_per_unit
            before = mod.launches
            compare(name, kfn, pfn, args, f"split by {how}")
            split_launches[f"{name} by {how}"] = mod.launches - before
            n_checked += 1
    ragged.SCRATCH_BYTES = budget
    if min(split_launches.values()) < 2:
        fail(f"a small scratch budget did not split the call: "
             f"{split_launches}")
    emit({"phase": "kernels_vs_plain", "cases": n_checked, "equal": True,
          "self_hit_score": self_score, "split_launches": split_launches,
          "seconds": time.perf_counter() - t0})

    # --- 4. golden values ------------------------------------------------------
    al = pt.Aligner(device=dev)  # BLOSUM50, gap 3/1
    gdb = pt.Database(["AACCGCTG"])
    (nw,) = al.align("ACCTCG", gdb, mode="end", algorithm="nw")
    (sw,) = al.align("ACCTCG", gdb, mode="score", algorithm="sw")
    doc = [r.score for r in pt.align(
        "ACCTG", ["AACCGCTG", "ATGCGCT", "TTATTACG"], gap_open=2,
        ordered=True, device=dev)]
    golden = {"nw": [nw.score, nw.query_end, nw.target_end],
              "sw": sw.score, "doctest": doc}
    if golden != {"nw": [44, 5, 7], "sw": 47, "doctest": [41, 31, 23]}:
        fail(f"golden values: {golden}")
    emit({"phase": "golden", **golden})

    # --- 5. the main path at full size -----------------------------------------
    rng = np.random.default_rng(12071)
    t0 = time.perf_counter()
    db_seqs = build_database(rng)
    letters = "ARNDCQEGHILKMFPSTWYV"
    queries = [
        "".join(letters[i] for i in rng.integers(0, 20, 256))
        for _ in range(67)
    ]
    db = pt.Database(db_seqs)
    n_t = len(db)
    residues = db.total_length
    emit({"phase": "main_setup", "targets": n_t, "residues": residues,
          "queries": len(queries), "query_length": 256,
          "seconds": time.perf_counter() - t0})

    for mod in (ragged, q8, sweep):
        mod.launches = 0
    t0 = time.perf_counter()
    res_s = al.align_arrays(queries, db, mode="score")
    res_e = al.align_arrays(queries, db, mode="end")
    single = al.align(queries[0], db, mode="score")
    counts = {"ragged": ragged.launches, "q8": q8.launches,
              "sweep": sweep.launches}
    first_seconds = time.perf_counter() - t0
    if counts["ragged"] < 1 or counts["q8"] < 1 or counts["sweep"] != 0:
        fail(f"main path launches: {counts}")
    for key in ("scores", "query_ends", "target_ends"):
        arr = res_e[key]
        if arr.shape != (67, n_t) or arr.dtype != np.int32:
            fail(f"{key}: shape {arr.shape} dtype {arr.dtype}")
    if not np.array_equal(res_s["scores"], res_e["scores"]):
        fail("score mode and end mode disagree")
    if [r.score for r in single] != res_s["scores"][0].tolist():
        fail("Aligner.align disagrees with align_arrays")
    if res_s["scores"].min() < 0:
        fail("negative sw score")

    enc_q = [np.frombuffer(db.alphabet.encode(q), np.uint8) for q in queries]
    srng = np.random.default_rng(256)
    pairs = [(int(a), int(b)) for a, b in zip(
        srng.integers(0, 67, 256), srng.integers(0, n_t, 256))]
    jobs = [(enc_q[a], db.get_encoded(b), S, GO, GE, "sw") for a, b in pairs]
    want = [(int(res_e["scores"][a, b]), int(res_e["query_ends"][a, b]),
             int(res_e["target_ends"][a, b])) for a, b in pairs]
    lo = max(n_t // 2 - 1000, 0)
    hi = min(lo + 1000, n_t)
    slice_q = queries[:11]
    for algo in ("nw", "hw", "ov"):
        out = al.align_arrays(slice_q, db, mode="end", algorithm=algo,
                              start=lo, end=hi)
        for a, b in zip(srng.integers(0, 11, 48), srng.integers(0, hi - lo, 48)):
            jobs.append((enc_q[a], db.get_encoded(lo + int(b)), S, GO, GE,
                         algo))
            want.append(tuple(int(out[k][a, b]) for k in
                              ("scores", "query_ends", "target_ends")))
    t1 = time.perf_counter()
    import concurrent.futures as cf
    import multiprocessing

    workers = min(8, os.cpu_count() or 1)
    with cf.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn")
    ) as ex:
        got = list(ex.map(naive.score_end, *zip(*jobs), chunksize=8))
    bad = [(j[5], w, tuple(g)) for j, w, g in zip(jobs, want, got)
           if tuple(w) != tuple(g)]
    if bad:
        fail(f"{len(bad)} of {len(jobs)} sampled pairs differ from the "
             f"oracle, e.g. {bad[:3]}")
    emit({"phase": "main_path", "launches": counts,
          "first_calls_seconds": first_seconds,
          "oracle_pairs": len(jobs), "oracle_equal": True,
          "oracle_seconds": time.perf_counter() - t1})

    # --- 6. timings and kernels against plain versions at main shapes ----------
    enc = enc_q
    plan = engine.plan_tier_launches(enc, safe_pad=True)
    (tier, lanes_q8, groups, v2_idx), = plan
    fpw = packing.pack_database_slice_flat(db, 0, n_t, lanes=lanes_q8)
    fp = packing.pack_database_slice_flat(db, 0, n_t)
    k2_in = engine._profiles_q8(enc, S, groups, lanes_q8, dev)
    k1_in = engine._profiles_for_cohort([enc[i] for i in v2_idx], S, dev)
    k1_single = engine._profiles_for_cohort([enc[0]], S, dev)
    shapes = {
        "q8": (q8.search_flat_q8, q8.search_flat_q8_reference,
               (*k2_in, *dev_flat(fpw)), fpw,
               sum(len(enc[i]) for g in groups for i in g)),
        "ragged": (ragged.search_flat, ragged.search_flat_reference,
                   (*k1_in, *dev_flat(fp)), fp,
                   sum(len(enc[i]) for i in v2_idx)),
        "ragged_single": (ragged.search_flat, ragged.search_flat_reference,
                          (*k1_single, *dev_flat(fp)), fp, len(enc[0])),
    }

    def time_launches(fn, args, n):
        fn(*args)  # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(*args)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / n

    results = {}
    for key, (kfn, pfn, base, fpk, query_rows) in shapes.items():
        errs = []
        for ends in (True, False):
            args = (*base, GO, GE, "sw", ends, fpk.chunk)
            out, err = compare(key, kfn, pfn, args, f"main shape ends={ends}")
            errs.append(err)
        ms = time_launches(kfn, args, 3)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pfn(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        cells = query_rows * residues
        ops = OPS_PER_CELL_SW_SCORE * cells
        out_bytes = 3 * 4 * out[0].numel()
        in_bytes = (fpk.flat_targets.size + fpk.lengths.nbytes
                    + sum(t.numel() * t.element_size() for t in base[:3]))
        ops_ms = ops / (N_SMS * INT32_LANES_PER_SM * max_sm_mhz * 1e6) * 1e3
        bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        results[key] = {
            "ms": ms, "plain_ms": plain_ms, "max_abs_err": max(errs),
            "cells": cells, "gcups": cells / (ms * 1e-3) / 1e9,
            "int_ops": ops, "bytes": in_bytes + out_bytes,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        }
        emit({"phase": "kernel_timing", "kernel": key, "mode": "sw score",
              **results[key], **card})

    def wall(fn, n):
        fn()  # warm
        times = []
        for _ in range(n):
            t1 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t1)
        return times

    def counted(fn):
        """Launches of each kernel during one call of ``fn``."""
        for mod in (ragged, q8, sweep):
            mod.launches = 0
        fn()
        return {"ragged": ragged.launches, "q8": q8.launches,
                "sweep": sweep.launches}

    def batch():
        return al.align_arrays(queries, db, mode="score")

    def one():
        return al.align(queries[0], db, mode="score")

    batch_launches = counted(batch)
    single_launches = counted(one)
    batch_s = wall(batch, 3)
    single_s = wall(one, 5)
    cells_batch = sum(len(q) for q in enc) * residues
    emit({"phase": "end_to_end", "align_arrays_seconds": batch_s,
          "align_arrays_gcups": cells_batch / float(np.median(batch_s)) / 1e9,
          "align_arrays_launches": batch_launches,
          "single_align_ms": [t * 1e3 for t in single_s],
          "single_align_launches": single_launches, **card})

    # --- 7. the kernels line, the card line, the result line ----------------
    entries = [
        ("q8", "q8", "pyopal_tpu_torch/csrc/q8.cu",
         "pyopal_tpu/ops/pallas_q8.py:138", counts["q8"]),
        ("ragged", "ragged", "pyopal_tpu_torch/csrc/ragged.cu",
         "pyopal_tpu/ops/pallas_ragged.py:400", counts["ragged"]),
    ]
    kernels = []
    for name, key, source, replaces, launches in entries:
        r = results[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "checked_against_plain": True,
        })
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(card_line, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
