#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (the first failure ends the run with a nonzero exit code):

1. the card: name and power limit from ``nvidia-smi``, torch and CUDA
   versions;
2. the build: the ten kernels (``pyopal_tpu_torch/csrc/ragged.cu``,
   ``q8.cu``, ``ragged_long.cu``, ``ragged_v1.cu``, ``ragged_strip.cu``,
   ``group.cu``, ``q8_narrow.cu``, K1's packed route ``ragged_packed.cu``,
   and full mode's ``traceback_dirs.cu``
   (T1) and ``traceback_walk.cu`` (T2)) compiled with ``nvcc`` for
   ``sm_90a``, in parallel, with each kernel's registers, stack frame
   and spills as ``ptxas`` reports them; beside them the probe
   ``tools/dpx_rate.cu``, which then measures the instructions per SM
   per clock of the two DPX instructions of the wavefront walk (K1-K6),
   alone and in the walk's sw cell, and of the packed walk's (K7) s16x2
   add-max and add-min, alone and in its cell of two cells; then the C
   codec and result types of ``pyopal_tpu_torch/native``, which must be
   built and active (``results.ScoreResult`` the C type, the C encoder
   bound in ``alphabet`` and ``io``), and ``_device_info()``;
3. each kernel against its plain PyTorch version on the card, every
   output plane in score and end modes: all four algorithms at several
   query tiers, with edge target lengths and a 2500-residue self-hit
   (score > 12000), and calls that a small scratch budget splits into
   several launches (K1, K2, K4-K7: at tiers of several passes, which
   need their pass buffer); K1's packed route at every K1 case of sw
   score mode the engine admits, equal to K1's int32 walk; K1 at the
   fine tiers 4608/5120/6144; K3
   segment by segment (scores, ends, the boundary rows and the trackers
   it hands on) at 32- and 64-row segments, and at 2048 rows (8 passes
   of the walk) for a 6,500-residue query against two 4,000-residue
   slices of itself; K6 (the grouped kernel) at queries of 13, 256 and
   1,000 residues with gaps 3/1, 1/3, 0/0 and -1/2 on every lane,
   padding lanes included; K4 and K5 (no ``safe_pad``) at every
   algorithm, both modes where the kernel has them, gaps 3/1, 1/3, 0/0
   and -1/2 (which walks every row, ends included), tiers 64 to 2048
   (K4) and 1024 and 4096 (K5), and with a random 32 x 32 matrix over
   targets that hold symbol
   31 as a real letter; K7 (the narrow pass) at tiers 64 to 1024 (one
   pass, then two and four through its buffer) and gaps 3/1, 0/0 and
   255/255, its scores also held against min(K2's, 255); then (3b) T1
   and T2 byte for byte against their plain versions on the batches of
   one 256-aa full-mode query over the main database (the shortest, the
   median and the longest, B = 64 at T_pad 1,920, at all four algorithms
   and gaps 3/1; the median at 1/3 and 0/0), on a tie-heavy batch, under
   a random 32 x 32 matrix, and where the walks change hands: queries of
   1, 15-17, 255-257 and 511-513 rows (a T1 thread's 8 rows, its 256-row
   pass, two passes) against targets on either side of 32, 64 and 128
   columns (T1's symbol tiles, T2's 64 x 64 tiles) at sw and nw 3/1 and
   sw -1/2;
4. the golden values through `pyopal_tpu_torch.Aligner` on ``cuda``;
5. the main path at full size: a synthetic 12,071-sequence database
   (the generator of ``bench.py``, seed 12071) searched with 67
   queries of 256 residues (8 full q8 groups + 3 leftovers) through
   ``Aligner.align_arrays`` in ``sw`` score and end modes and one
   ``Aligner.align``, with the launch counters set to 0 just before and
   read just after; a seeded sample of the results is checked against
   the scalar oracle, and nw/hw/ov end mode on a 1,000-target slice too;
   then the long-query path on the same database: a 35,000-residue
   query (18 K3 segments) and a 5,000-residue one (one K1 launch at the
   5,120 fine tier) through ``Aligner.align`` in end and score modes,
   counted the same way, held against the plain versions on a
   1,000-target slice and against the oracle on the shortest targets;
   then the I/O path (5g): the main database written as FASTA, read with
   the C scanner and with the Python fallback (equal), saved and loaded
   as an archive, and searched through one ``Aligner.align`` and
   ``align_arrays`` in score and end modes, counted (K1 3, K2 2), its
   results (C ``ScoreResult`` objects) equal to the main database's bit
   for bit, each I/O step timed;
   then the sharded path (``pyopal_tpu_torch.parallel``) on the same
   database: ``align_arrays_sharded`` over a 4-shard mesh on the card in
   sw score and end modes (K2 and K1 once per shard per cohort), equal to
   ``align_arrays``; ``sharded_search_group`` with K6 over the grouped
   pack of the whole database for one query, equal to ``Aligner.align``
   in end mode, each of its 40 K6 launches (4 shards x 10 length
   buckets) held against K6's plain version on the same tensors, and
   ``top_k_merge`` against numpy's; two ranks of a
   ``gloo`` group on the card (processes of this script, 2 shards each)
   and a one-rank ``nccl`` group, each equal to the single-process
   result (two ``nccl`` ranks where there are two cards);
   then the path without ``safe_pad`` on the same database, each call
   counted: ``sharded_search_flat`` at its defaults over the 4 shards
   (K4 for 3 x 256 aa in both modes and 1 x 256 aa ``nw``, K5 for 1,000
   and 3,000 aa; 4 launches a call), equal to the same call with
   ``safe_pad=True`` (K1), with K4's score-mode end planes; the engine's
   route for a 32-column matrix (BLOSUM50 inside -4): the 67 queries in
   one K4 launch in each mode, equal to ``align_arrays``, a 1,000-aa
   query in end mode (K4, equal to ``Aligner.align``), a 3,000-aa query
   in score mode (K5, equal to K1) and end mode (K3, 2 launches, equal to
   its plain version on a 1,000-target slice); K7 on the main path's 8
   q8 groups, one query a 256-residue stretch of a target, its scores
   min(K2's, 255) and its flagged lanes counted;
   then K1-K7 against their plain versions at full width where the
   wavefront walk changes hands: query lengths on either side of a
   thread's 16 rows and of a pass (64, 128, 256 rows), through several
   passes (K1 up to 515 rows, K2's q8 groups up to 512, K3 a 2,563-row
   query in two segments, K4 up to 512 rows and K5 2,560-2,563 rows,
   both also at a negative gap, which walks every row; K6 at 17-512
   residues over the database stacked as one group, Q_pad 24 and 264
   among them, also at a negative gap; K7's pairs of slots of 16/17,
   255/256 and 511/512 residues, a group of 7 queries, a group of
   self-hits past the cap), on the main database and on a tie-heavy
   database of 12,071 repeated-motif sequences at its lengths, searched
   with motif queries;
   then full mode and top-k at full width (5f), counted: one 256-aa query
   through ``Aligner.align(mode="full")`` (K1, then T1 and T2 once per
   batch), equal to end mode and, on 16 pairs, to the oracle's traceback;
   ``align_arrays(mode="full")`` of one q8 group against ``align_batch``;
   ``align_top_k(k=100)`` for the 67 queries and ``align_top_k_sharded``
   over the 4 shards equal to it, with a tie case that takes the second
   candidate gather; ``align_arrays_sharded(mode="full")``; the golden
   values in full mode;
6. timings with CUDA events after a warm-up, each kernel held against
   its plain version at the main path's shapes (K3: one 2048-row
   segment of the 35,000-residue query; K6: the sharded path's 40
   launches for one query, as the host feeds them and with all of them
   queued before the first runs, and the whole database stacked as one
   group; K4, K5 and K7 at phase 5d's shapes, also against their plain
   versions on a 1,000-target slice), the bound of each kernel over the
   cells its function needs (K5's walked rows reported apart; the
   wavefront walk's kernels, K1-K6, at their six DPX-fused instructions
   a cell, their plain int32 bound beside it; K7 at 5.5 packed s16x2
   instructions for two cells, with K2's bound and K2's time on the same
   groups beside it; K1's packed route at 6.5 for two cells, K1's bound
   and time beside it),
   end-to-end throughput, long-query and sharded call times, and each
   kernel's launches in one ``align_arrays`` and one ``align`` call,
   counted; one 256-aa ``align`` split into K1 (CUDA events around its
   launch), result building and the rest of the call (each call timed
   with `pyopal_tpu_torch.utils.profiling.Timer`), with the C and the
   Python result builders timed on the same arrays; T1 and T2 per batch
   of one full-mode query (three launches queued behind a sleep on the
   card, so that the host's time stays out),
   their bounds (T1: the direction bytes, or the recurrence's 16 int32
   operations a cell at the int32 rate; T2: a 32-byte sector a walk step),
   the longest walk of each launch and T2's clock cycles a step on it, T1's
   threads a pair and rows a thread and T2's tile, and the parts of
   ``align(mode="full")`` (score pass, traceback, result building) with
   the host's share;
7. the ``kernels`` line, then the card line, then the result line.

With ``--rank R --world N --backend B --init FILE --out FILE`` the
script is instead one rank of phase 5's process groups.

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
#: int32 operations per DP cell of sw score mode in plain int32, counted
#: from the recurrence at its least: G = H - go (1 subtraction, shared by
#: the next column's E and the next row's F), E = max(G, E - ge) (2), F =
#: max(G, F - ge) (2), diagonal max(H + s, E) (2), clamp at 0 (1), H = max
#: with F (1), running best (1): ``int32_bound_ms`` of every kernel
OPS_PER_CELL_SW_SCORE = 10
#: instructions per cell of the wavefront walk (``csrc/wave.cuh``: K1-K6)
#: with Hopper's DPX add-max: E, F and the diagonal one
#: add-max each, H = max(H, F, 0), G = H - go and the running best; its
#: bound counts them at the highest of the int32 rate and the rates
#: measured by ``tools/dpx_rate.cu`` in this run (each DPX instruction
#: alone, and the cell's six together)
OPS_PER_CELL_WAVE = 6
#: packed instructions per two cells of K7's walk (``csrc/wave.cuh``,
#: NARROW: two int16 cells in each): E, F and the diagonal one s16x2
#: add-max each, H = max(H, F, 0), G = min(H - go, 255 - go) one add-min,
#: and half of a three-input packed max, which takes two rows' G into the
#: running best (ptxas merges the unmasked walk's rows in pairs); its bound
#: counts them at the highest of the int32 rate and the s16x2 rates
#: ``tools/dpx_rate.cu`` measures in this run
OPS_PER_PAIR_NARROW = 5.5
#: packed instructions per two cells of K1's packed route
#: (``csrc/ragged_packed.cu``): K7's 5.5 and the byte permute that builds
#: a row's pair of profile entries from the two lanes' symbols
OPS_PER_PAIR_K1_PACKED = OPS_PER_PAIR_NARROW + 1
#: int32 operations per cell of T1's direction pass (sw), counted from the
#: recurrence at its least: G = H - go (1, shared by the next column's E
#: and the next row's F), E = max(G, E - ge) (2), F = max(G, F - ge) (2),
#: the diagonal add (1), its max with E (1), the clamp at 0 (1), the max
#: with F (1), the code's compares of H with the diagonal, E and 0 (3), the
#: open bits' compares (2) and packing the three fields into a byte (2);
#: what the kernel runs beyond them (the code's selects, a step's
#: shuffles, loads and stores) and the schedulers a batch of few pairs
#: leaves idle are its gap to the bound
OPS_PER_CELL_DIRS = 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT32_LANES_PER_SM = 64
N_SMS = 132
DPX_PROBE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tools", "dpx_rate.cu")


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


def main_workload():
    """The main path's database and its 67 queries of 256 residues."""
    rng = np.random.default_rng(12071)
    db_seqs = build_database(rng)
    letters = "ARNDCQEGHILKMFPSTWYV"
    queries = [
        "".join(letters[i] for i in rng.integers(0, 20, 256))
        for _ in range(67)
    ]
    return db_seqs, queries


def rank_main(argv):
    """One rank of a process group: ``align_arrays_sharded`` in end mode
    over 2 shards per rank on this rank's card; writes the result, the
    payload bytes it packed and its seconds to ``--out`` (``.npz``)."""
    import argparse

    import torch
    import pyopal_tpu_torch as pt
    from pyopal_tpu_torch.parallel import (
        ShardedFlat, align_arrays_sharded, device_mesh,
        initialize_distributed,
    )

    ap = argparse.ArgumentParser()
    for name in ("--rank", "--world"):
        ap.add_argument(name, type=int, required=True)
    for name in ("--backend", "--init", "--out"):
        ap.add_argument(name, required=True)
    a = ap.parse_args(argv)
    if a.backend == "nccl":
        torch.cuda.set_device(a.rank % torch.cuda.device_count())
    t0 = time.perf_counter()
    initialize_distributed(a.backend, f"file://{a.init}", a.world, a.rank)
    db_seqs, queries = main_workload()
    db = pt.Database(db_seqs)
    mesh = device_mesh(2 * a.world)
    t1 = time.perf_counter()
    out = align_arrays_sharded(queries, db, mode="end", mesh=mesh)
    t2 = time.perf_counter()
    packs = [v for v in db._pack_cache.values() if isinstance(v, ShardedFlat)]
    np.savez(
        a.out, **out, seconds=t2 - t1, setup_seconds=t1 - t0,
        local_shards=sorted({s for p in packs for s in p.payloads}),
        local_bytes=sum(p.local_payload_bytes for p in packs),
        total_bytes=sum(p.rows_max * p.lanes * p.n_shards for p in packs),
        device=str(mesh.devices[2 * a.rank]),
    )
    torch.distributed.destroy_process_group()
    return 0


def ptxas_summary(log):
    """Registers per kernel function and the largest stack frame and
    spill stores/loads (bytes) that ``nvcc -Xptxas -v`` reported."""
    import re

    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    worst = {k: 0 for k in ("stack", "spill_stores", "spill_loads")}
    for m in re.finditer(r"(\d+) bytes stack frame, (\d+) bytes spill "
                         r"stores, (\d+) bytes spill loads", log):
        for k, v in zip(worst, m.groups()):
            worst[k] = max(worst[k], int(v))
    return {"registers": regs, **worst}


def start_dpx_probe(build_dir, nvcc, flags):
    """Start ``nvcc`` for ``tools/dpx_rate.cu``; returns (process,
    library)."""
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / "dpx_rate.so"
    proc = subprocess.Popen([nvcc, *flags, "-o", str(lib), DPX_PROBE],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, lib


#: the probe's modes: the walk's int32 DPX instructions and cell, then
#: the packed walk's s16x2 ones and its cell of two cells
DPX_MODES = ("viaddmax_s32", "vimax_s32_relu", "sw_cell", "viaddmax_s16x2",
             "viaddmin_s16x2", "narrow_cell")


def dpx_rates(lib, n_sms):
    """Instructions per SM per clock of each DPX instruction of the
    wavefront walk alone and of its sw cell's six together, and of the
    packed walk's s16x2 add-max and add-min alone and of two rows of its
    cell, 5.5 instructions a row (``tools/dpx_rate.cu``): two 1024-thread
    blocks per SM, each SM's instructions over the span of its blocks'
    clocks, the highest over the SMs."""
    import ctypes

    import torch

    fn = ctypes.CDLL(str(lib)).pyopal_dpx_rate_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks, threads, iters = 2 * n_sms, 1024, 4096
    dev = torch.device("cuda")
    # -ge, go, a start, E and F's start, eight profile scores
    inp = torch.tensor([-1, 3, 0, -100, 5, -2, 1, 3, -1, 4, 0, 2],
                       dtype=torch.int32, device=dev)
    out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
    clocks = torch.empty((blocks, 3), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rates = {}
    for mode, name in enumerate(DPX_MODES):
        # instructions a thread issues per step: chains x instructions (the
        # packed cell: two rows a step)
        per_step = {"sw_cell": 4 * OPS_PER_CELL_WAVE,
                    "narrow_cell": 4 * 2 * OPS_PER_PAIR_NARROW}.get(name, 8)
        for _ in range(2):  # the first launch warms the card up
            err = fn(inp.data_ptr(), out.data_ptr(), clocks.data_ptr(), mode,
                     blocks, iters, stream)
            if err:
                fail(f"the DPX probe did not launch: error {err}")
        c = clocks.cpu().numpy()
        per_sm = []
        for sm in np.unique(c[:, 0]):
            mine = c[c[:, 0] == sm]
            span = int(mine[:, 2].max() - mine[:, 1].min())
            per_sm.append(
                len(mine) * threads * iters * per_step / span)
        rates[name] = max(per_sm)
    return rates


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
    from pyopal_tpu_torch.ops import _cuda, engine, group, naive, packing
    from pyopal_tpu_torch.ops import q8, ragged, ragged_long, sweep, traceback
    from pyopal_tpu_torch.parallel import (
        align_arrays_sharded, align_top_k_sharded, device_mesh,
        initialize_distributed,
    )
    from pyopal_tpu_torch.results import cigar_string
    from pyopal_tpu_torch.parallel import sharded
    from pyopal_tpu_torch.parallel import sharded_flat as sfm
    from pyopal_tpu_torch import alphabet as alphabet_mod
    from pyopal_tpu_torch import io as io_mod
    from pyopal_tpu_torch import native
    from pyopal_tpu_torch import results as results_mod
    from pyopal_tpu_torch.utils.profiling import Timer

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
    probe, probe_lib = start_dpx_probe(_cuda.BUILD_DIR, _cuda._nvcc(),
                                       _cuda.NVCC_FLAGS)
    try:
        secs = _cuda.build_all()
    finally:
        probe_log = probe.communicate()[0]
    if probe.returncode != 0:
        fail(f"nvcc failed for tools/dpx_rate.cu:\n{probe_log}")
    emit({
        "phase": "build", "nvcc_flags": _cuda.NVCC_FLAGS,
        "seconds_per_kernel": secs,
        "seconds": time.perf_counter() - t0,
        "libraries": sorted(p.name for p in _cuda.BUILD_DIR.glob("*.so")),
        "ptxas": {k: ptxas_summary(v) for k, v in _cuda.build_logs.items()},
        "dpx_rate_ptxas": ptxas_summary(probe_log),
    })
    # the rate at which the wavefront walk's bound counts its instructions
    dpx = dpx_rates(probe_lib, N_SMS)
    wave_lanes = max(INT32_LANES_PER_SM, *(dpx[k] for k in DPX_MODES[:3]))
    narrow_rate = max(INT32_LANES_PER_SM, *(dpx[k] for k in DPX_MODES[3:]))
    emit({"phase": "dpx_rate", "instructions_per_sm_clock": dpx,
          "int32_lanes_per_sm": INT32_LANES_PER_SM,
          "wave_bound_lanes_per_sm": wave_lanes,
          "narrow_bound_instructions_per_sm": narrow_rate, **card})

    # the C codec and result types (``pyopal_tpu_torch/native``), built at
    # the package's import: the run fails unless both are active, so that
    # no pure-Python fallback hides what runs
    active = {
        "ensure_built": native.ensure_built(),
        "results": results_mod.ScoreResult.__module__,
        "alphabet_encoder": alphabet_mod._native_encoder is not None,
        "io_encoder": io_mod._native_encoder is not None,
    }
    if active != {"ensure_built": True,
                  "results": "pyopal_tpu_torch.native._results",
                  "alphabet_encoder": True, "io_encoder": True}:
        fail(f"the C extensions are not active: {active}")
    emit({"phase": "native", **active,
          "libraries": [sys.modules[f"pyopal_tpu_torch.native.{n}"].__file__
                        for n in ("_encoder", "_results")]})
    emit({"phase": "device_info", **pt._device_info()})

    S = pt.ScoringMatrix.from_name("BLOSUM50").int_data()
    algos = ("sw", "nw", "hw", "ov")

    def dev_flat(fp):
        return engine._flat_device(fp, dev)[:5]

    def stacked_group(gp):
        """A grouped pack as one group on the card: every block at the
        longest group's t_pad, ``(targets, lengths)``."""
        t_big = max(g.t_pad for g in gp.groups)
        full_t = np.concatenate([
            np.pad(g.targets, ((0, 0), (0, t_big - g.t_pad), (0, 0)))
            for g in gp.groups])
        full_l = np.concatenate([g.lengths for g in gp.groups])
        return (torch.from_numpy(full_t).to(dev),
                torch.from_numpy(full_l).to(dev))

    plain_seconds = {}  # the last plain run of each kernel

    # each kernel's launch count, kept by its wrapper's module: a dict by
    # kernel where a module launches several, else an int
    def launch_counts():
        return {**ragged.launches, **q8.launches, **traceback.launches,
                "ragged_long": ragged_long.launches,
                "group": group.launches, "sweep": sweep.launches}

    def zero_counts():
        for d in (ragged.launches, q8.launches, traceback.launches):
            d.update(dict.fromkeys(d, 0))
        ragged_long.launches = group.launches = sweep.launches = 0

    counters = list(launch_counts())

    def only(**want):
        """Launch counts with every kernel not named at 0."""
        return {k: want.get(k, 0) for k in counters}

    def compare(name, kernel, plain, args, label):
        ko = kernel(*args)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        po = plain(*args)
        torch.cuda.synchronize()
        plain_seconds[name] = time.perf_counter() - t1
        err = max(int((k.long() - p.long()).abs().max()) for k, p in
                  zip(ko, po)) if ko[0].numel() else 0
        if err != 0 or any(k.shape != p.shape for k, p in zip(ko, po)):
            fail(f"{name} differs from its plain version at {label}: {err}")
        return ko, err

    k3_errs = [0]

    def compare_segments(q, fp, algo, ends, qseg, label):
        """K3 against its plain version segment by segment, both given
        the kernel's state from the segment before; returns the kernel's
        launches and its last outputs."""
        flat = dev_flat(fp)
        n_seg = -(-len(q) // qseg)
        prof = torch.from_numpy(ragged.make_profiles_host(
            [q], S, q_pad=n_seg * qseg)[0]).to(dev)
        hb = torch.zeros(flat[0].shape, dtype=torch.int32, device=dev)
        fb = torch.full_like(hb, ragged_long.NEG)
        trk = torch.zeros((ragged_long.N_TRACK, *fp.lengths.shape[::2]),
                          dtype=torch.int32, device=dev)
        before = ragged_long.launches
        for s in range(n_seg):
            args = (prof[s * qseg:(s + 1) * qseg], len(q), s * qseg, *flat,
                    hb, fb, trk, GO, GE, algo, ends, fp.chunk)
            out, err = compare(
                "ragged_long", ragged_long.search_segment,
                ragged_long.segment_reference, args,
                f"{label} {algo} ends={ends} segment {s}")
            k3_errs.append(err)
            hb, fb, trk = out[3:]
        return ragged_long.launches - before, out

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
    m_abs = int(np.abs(S).max())

    def k1_packed(label, args, k1_out):
        """K1's packed route where the engine's int16 bound admits the
        call (H's cap at min(Q_pad, T_max) x max |S|), whatever its
        blocks: equal to K1's int32 walk bit for bit, in one launch.
        Returns the cases checked."""
        rows = min(args[0].shape[1], int(args[3].max()))
        if not engine._packed_exact_domain("sw", False, GO, GE, m_abs, rows):
            return 0
        cap = rows * m_abs
        before = ragged.launches["ragged_packed"]
        out = ragged.search_flat(*args, packed_cap=cap)
        if ragged.launches["ragged_packed"] != before + 1:
            fail(f"K1 packed {label}: not one launch")
        if not all(torch.equal(a, b) for a, b in zip(out, k1_out)):
            fail(f"K1 packed {label}: differs from K1's int32 walk")
        return 1

    split_cases = []  # (name, module, kernel, plain, args, unit rows, lanes)
    for label, qls, fp in k1_cases:
        queries = [rng.integers(0, 20, n).astype(np.uint8) for n in qls]
        profs = torch.from_numpy(ragged.make_profiles_host(queries, S)).to(dev)
        qlens = torch.tensor(qls, dtype=torch.int32, device=dev)
        for algo in algos:
            for ends in (False, True):
                args = (profs, qlens, *dev_flat(fp), GO, GE, algo, ends,
                        fp.chunk, True)
                out, _ = compare("ragged", ragged.search_flat,
                                 ragged.search_flat_reference, args,
                                 f"{label} {algo} ends={ends}")
                n_checked += 1
                if algo == "sw" and not ends:
                    n_checked += k1_packed(label, args, out)
        if label == "tier1024":  # several passes: K1's pass buffer
            split_cases.append((
                "ragged", ragged.search_flat, ragged.search_flat_reference,
                args, 8 * ragged.wave_buffer_rows(
                    profs.shape[1], fp.flat_targets.shape[0], fp.n_blocks),
                fp.lengths.size))
    # the 2500-residue self-hit at the 4096 tier
    profs = torch.from_numpy(ragged.make_profiles_host([big], S)).to(dev)
    qlens = torch.tensor([len(big)], dtype=torch.int32, device=dev)
    for algo in algos:
        for ends in (False, True):
            out, _ = compare(
                "ragged", ragged.search_flat, ragged.search_flat_reference,
                (profs, qlens, *dev_flat(fp_big), GO, GE, algo, ends,
                 fp_big.chunk, True), f"tier4096 self-hit {algo} ends={ends}")
            n_checked += 1
            if algo == "sw":
                pos = int(fp_big.inv_pos[len(seqs)])
                self_score = int(out[0].reshape(-1)[pos])
                self_hit = [int(o.reshape(-1)[pos]) for o in out]  # ends
                if self_score <= 12000:
                    fail(f"2500-aa self-hit scored {self_score}")
    k2_cases = [
        ("tier64", 512, [64, 1, 40, 63, 7, 50, 29, 33, 21, 3, 64, 12, 9, 17]),
        ("tier256", 512, [256, 129, 200, 255, 140, 180, 222, 250]),
        ("tier512", 256, [512, 257, 300, 400, 511, 260, 333, 444, 9, 100]),
    ]
    long_seq = next(t for t in seqs if len(t) >= 256)

    def k2_packed(label, args, k2_out):
        """K2's exact route: the packed walk with H's cap at Q_pad x max
        |S| equals K2's int32 walk bit for bit, in one launch."""
        cap = args[0].shape[1] // q8.QB * int(np.abs(S).max())
        before = q8.launches["q8_packed"]
        out = q8.search_flat_q8(*args, packed_cap=cap)
        if q8.launches["q8_packed"] != before + 1:
            fail(f"K2 packed {label}: not one launch")
        if not all(torch.equal(a, b) for a, b in zip(out, k2_out)):
            fail(f"K2 packed {label}: differs from K2's int32 walk")
        return out

    k7_flagged = {}
    k7_args = []  # the last call at gaps 3/1

    def k7_cases(label, profs, qv, maxq, fp):
        """K7, the narrow pass, at gaps 3/1, 0/0 and 255/255: against its
        plain version, and its scores min(K2's, 255) on the same tensors;
        one launch a call.  Returns the cases checked."""
        for gaps in ((3, 1), (0, 0), (255, 255)):
            args = (profs, qv, maxq, *dev_flat(fp), *gaps, "sw", False,
                    fp.chunk, True)
            before = q8.launches["q8_narrow"]
            out, _ = compare("q8_narrow", q8.search_flat_q8,
                             q8.search_flat_q8_reference, args,
                             f"K7 {label} gaps={gaps}")
            if q8.launches["q8_narrow"] != before + 1:
                fail(f"K7 {label} gaps={gaps}: not one launch")
            exact = q8.search_flat_q8(*args[:-1])[0]
            if not torch.equal(out[0], exact.clamp(max=q8.NARROW_CAP)):
                fail(f"K7 {label} gaps={gaps}: scores are not min(K2, 255)")
            k7_flagged[f"{label} gaps={gaps}"] = int(
                (out[0] == q8.NARROW_CAP).sum())
            if gaps == (3, 1):
                k7_args[:] = [args]
        return 3
    for label, lanes, qls in k2_cases:
        fp = packing.pack_sequences_flat(seqs, lanes=lanes)
        queries = [rng.integers(0, 20, n).astype(np.uint8) for n in qls]
        if label == "tier256":  # a self-hit past K7's cap of 255
            queries[0] = long_seq[:256].copy()
        groups = q8.plan_groups(qls)
        arrays = q8.make_profiles_q8_host(queries, S, groups, lanes=lanes)
        profs, qv, maxq = (torch.from_numpy(a).to(dev) for a in arrays)
        for algo in algos:
            for ends in (False, True):
                args = (profs, qv, maxq, *dev_flat(fp), GO, GE, algo, ends,
                        fp.chunk)
                out, _ = compare(
                    "q8", q8.search_flat_q8, q8.search_flat_q8_reference,
                    args, f"{label} {algo} ends={ends}")
                n_checked += 1
                if algo == "sw" and not ends:  # K2's packed route: K2's
                    k2_packed(label, args, out)
                    n_checked += 1
        k2_args = args
        n_checked += k7_cases(label, profs, qv, maxq, fp)
        if label == "tier512":  # two passes: K2's and K7's pass buffers
            for name, slots, a in (("q8", q8.QB, k2_args),
                                   ("q8_narrow", q8.QB // 2, k7_args[0])):
                split_cases.append((
                    name, q8.search_flat_q8, q8.search_flat_q8_reference, a,
                    8 * slots * ragged.wave_buffer_rows(
                        512, fp.flat_targets.shape[0], fp.n_blocks),
                    fp.lengths.size))
    # K7 at the 1024 tier: four passes through its buffer, one query a
    # stretch of a target past the cap
    fp = packing.pack_sequences_flat(seqs, lanes=512)
    qls = [1024, 700, 513, 1000, 9, 600, 800, 250, 300, 520]
    queries = [rng.integers(0, 20, n).astype(np.uint8) for n in qls]
    queries[7] = long_seq[:250].copy()
    arrays = q8.make_profiles_q8_host(queries, S, q8.plan_groups(qls),
                                      lanes=512)
    n_checked += k7_cases(
        "tier1024", *(torch.from_numpy(a).to(dev) for a in arrays), fp)
    if min(k7_flagged[f"{t} gaps={g}"] for t in ("tier256", "tier1024")
           for g in ((3, 1), (0, 0), (255, 255))) < 1:
        fail(f"K7 flagged no lane: {k7_flagged}")

    # K4 and K5 (no safe_pad): every algorithm, both modes where the
    # kernel has them, gaps 3/1, 1/3, 0/0 and -1/2 (every row walked, ends
    # too), over the edge lengths; K4 up to its 2048 tier (two queries,
    # 8 passes), K5 at 1024 and at 4096 (the 2500-residue self-hit); a
    # random 32 x 32 matrix over targets that hold symbol 31 as a real
    # letter
    gap_sets = ((3, 1), (1, 3), (0, 0), (-1, 2))
    m32 = rng.integers(-6, 7, (32, 32))
    m32 = ((m32 + m32.T) // 2).astype(np.int32)
    seqs32 = [rng.integers(0, 32, int(n)).astype(np.uint8) for n in lens]
    fp32 = packing.pack_sequences_flat(seqs32)
    v1_cases = [  # (label, query lengths, targets, matrix, pack, modes, gaps)
        ("K4 tier64", [64, 40, 9], seqs, S, fp128, (False, True), gap_sets),
        ("K4 tier256", [256, 200, 129], seqs, S, fp128, (False, True),
         gap_sets),
        ("K4 tier2048", [2000, 600], seqs, S, fp128, (False, True),
         ((3, 1), (-1, 2))),
        ("K5 tier1024", [1000, 700], seqs, S, fp128, (False,), gap_sets),
        ("K4 32x32 tier256", [256, 100], seqs32, m32, fp32, (False, True),
         ((3, 1),)),
        ("K5 32x32 tier512", [300], seqs32, m32, fp32, (False,), ((3, 1),)),
    ]
    v1_launches = {"ragged_v1": 0, "ragged_strip": 0}
    for label, qls, tgts, mat, fp, modes, gaps_list in v1_cases:
        alpha = mat.shape[1] if mat is m32 else 20
        queries = [rng.integers(0, alpha, n).astype(np.uint8) for n in qls]
        queries[0][3:33] = tgts[7][40:70]  # a high-scoring stretch
        profs = torch.from_numpy(
            ragged.make_profiles_host(queries, mat)).to(dev)
        qlens = torch.tensor(qls, dtype=torch.int32, device=dev)
        for algo in algos:
            for ends in modes:
                for gaps in gaps_list:
                    name = ragged.flat_route(profs.shape[1], ends, False)
                    before = launch_counts()[name]
                    args = (profs, qlens, *dev_flat(fp), *gaps, algo, ends,
                            fp.chunk, False)
                    compare(name, ragged.search_flat,
                            ragged.search_flat_reference, args,
                            f"{label} {algo} ends={ends} gaps={gaps}")
                    if launch_counts()[name] != before + 1:
                        fail(f"{label}: {name} did not launch once")
                    v1_launches[name] += 1
                    n_checked += 1
        if label in ("K4 tier2048", "K5 tier1024"):  # their pass buffer
            split_cases.append((
                name, ragged.search_flat, ragged.search_flat_reference, args,
                8 * ragged.wave_buffer_rows(
                    profs.shape[1], fp.flat_targets.shape[0], fp.n_blocks),
                fp.lengths.size))
    # K5 on the 2500-residue self-hit at the 4096 tier: K1's score
    profs = torch.from_numpy(ragged.make_profiles_host([big], S)).to(dev)
    qlens = torch.tensor([len(big)], dtype=torch.int32, device=dev)
    for algo in ("sw", "ov"):
        out, _ = compare(
            "ragged_strip", ragged.search_flat, ragged.search_flat_reference,
            (profs, qlens, *dev_flat(fp_big), GO, GE, algo, False,
             fp_big.chunk, False), f"K5 tier4096 self-hit {algo}")
        n_checked += 1
        v1_launches["ragged_strip"] += 1
        pos = int(fp_big.inv_pos[len(seqs)])
        if algo == "sw" and int(out[0].reshape(-1)[pos]) != self_score:
            fail(f"K5 2500-aa self-hit: {int(out[0].reshape(-1)[pos])}, "
                 f"K1's {self_score}")
    # calls split into several launches by a small scratch budget: one
    # unit (query or group) and 128 lanes per launch, or one unit and
    # every lane per launch
    budget = ragged.SCRATCH_BYTES
    split_launches = {}
    for name, kfn, pfn, args, lane_bytes, n_lanes in split_cases:
        for how, lanes_per_unit in (("lanes", 128), ("units", n_lanes)):
            ragged.SCRATCH_BYTES = lane_bytes * lanes_per_unit
            before = launch_counts()[name]
            compare(name, kfn, pfn, args, f"split by {how}")
            split_launches[f"{name} by {how}"] = (
                launch_counts()[name] - before)
            n_checked += 1
    # (K3 keeps no scratch: one launch per segment whatever the budget;
    # its passes are held below, at 2048-row segments)
    ragged.SCRATCH_BYTES = budget
    if min(split_launches.values()) < 2:
        fail(f"a small scratch budget did not split the call: "
             f"{split_launches}")

    # K1 at the fine tiers of single long queries
    for Q in (4500, 5000, 6000):
        q = rng.integers(0, 20, Q).astype(np.uint8)
        tier = ragged.fine_qpad(Q)
        profs = torch.from_numpy(
            ragged.make_profiles_host([q], S, q_pad=tier)).to(dev)
        qlens = torch.tensor([Q], dtype=torch.int32, device=dev)
        for algo in algos if Q == 5000 else ("sw",):
            for ends in (False, True) if algo == "sw" else (True,):
                compare("ragged", ragged.search_flat,
                        ragged.search_flat_reference,
                        (profs, qlens, *dev_flat(fp128), GO, GE, algo, ends,
                         fp128.chunk, True),
                        f"fine tier {tier} {algo} ends={ends}")
                n_checked += 1

    # K3 segment by segment: 3 segments of 32 rows and 2 of 64, each
    # query holding a 30-residue stretch of a target
    k3_launches = 0
    for qseg, Q in ((32, 70), (64, 100)):
        q = rng.integers(0, 20, Q).astype(np.uint8)
        q[5:35] = seqs[7][90:120]
        for algo in algos:
            for ends in (False, True):
                k3_launches += compare_segments(
                    q, fp128, algo, ends, qseg, f"qseg {qseg}")[0]
                n_checked += -(-Q // qseg)
    # 2048-row segments: a 6,500-residue query against two 4,000-residue
    # slices of itself that cross the 2048/4096/6144 row boundaries
    q = rng.integers(0, 20, 6500).astype(np.uint8)
    fp_long = packing.pack_sequences_flat(
        [seqs[0], seqs[1], seqs[4], seqs[7], q[1000:5000], q[2500:6500]])
    pos = [int(fp_long.inv_pos[i]) for i in (4, 5)]
    long_hits = {}
    for algo, ends in (("sw", False), ("sw", True), ("ov", True)):
        n, out = compare_segments(q, fp_long, algo, ends,
                                  ragged_long.QSEG, "qseg 2048")
        k3_launches += n
        n_checked += n
        long_hits[f"{algo} ends={ends}"] = [
            [int(o.reshape(-1)[p]) for o in out[:3]] for p in pos]
    sw_hits = long_hits["sw ends=True"]
    if min(h[0] for h in sw_hits) <= 12000:
        fail(f"4,000-residue self-hits scored {sw_hits}")

    # K6: one query x a group of two 128-lane blocks at t_pad 512, every
    # lane and plane: edge lengths, zero-length (padding) lanes, symbols
    # past each length, queries with and without pad rows (13: one of its
    # two threads idle; 1,000: four passes), gaps 3/1, 1/3, 0/0 and -1/2
    glens = rng.integers(0, 301, (2, 128)).astype(np.int32)
    glens[0, :9] = [0, 1, 31, 32, 33, 255, 256, 257, 300]
    glens[1, -3:] = 0
    gtgt = rng.integers(0, 20, (2, 512, 128)).astype(np.uint8)
    gtgt_d = torch.from_numpy(gtgt).to(dev)
    glens_d = torch.from_numpy(glens).to(dev)
    k6_launches = group.launches
    for Q in (13, 256, 1000):
        q = rng.integers(0, 20, Q).astype(np.uint8)
        q[:10] = gtgt[0, 20:30, 7]
        pq = group.make_profile(q, S, dev)
        for algo in algos:
            for ends in (False, True):
                for gaps in gap_sets:
                    compare("group", group.search_group,
                            group.search_group_reference,
                            (pq, gtgt_d, glens_d, *gaps, algo, ends),
                            f"K6 Q={Q} {algo} ends={ends} gaps={gaps}")
                    n_checked += 1
        if Q == 1000:  # the pass buffer of one 128-lane block a launch
            ragged.SCRATCH_BYTES = 8 * gtgt.shape[1] * 128
            before = group.launches
            compare("group", group.search_group,
                    group.search_group_reference,
                    (pq, gtgt_d.to(torch.int32), glens_d, GO, GE, "sw",
                     True), "K6 split by lanes")
            split_launches["group by lanes"] = group.launches - before
            ragged.SCRATCH_BYTES = budget
            n_checked += 1
    if split_launches["group by lanes"] != 2:
        fail(f"K6 split: {split_launches}")
    # the 2500-residue self-hit: its group (t_pad 2560) of the grouped pack
    gp = packing.pack_sequences(seqs + [big])
    g = next(g for g in gp.groups if (g.indices == len(seqs)).any())
    pq = group.make_profile(big, S, dev)
    lane = np.argwhere(g.indices.reshape(-1) == len(seqs))[0, 0]
    for algo, ends in (("sw", False), ("sw", True), ("ov", True)):
        out, _ = compare(
            "group", group.search_group, group.search_group_reference,
            (pq, torch.from_numpy(g.targets).to(dev),
             torch.from_numpy(g.lengths).to(dev), GO, GE, algo, ends),
            f"K6 2500-residue self-hit {algo} ends={ends}")
        n_checked += 1
        hit = [int(o.reshape(-1)[lane]) for o in out]
        if algo == "sw" and ends and hit != self_hit:
            fail(f"K6 2500-aa self-hit: {hit}, K1's: {self_hit}")
    k6_launches = group.launches - k6_launches
    emit({"phase": "kernels_vs_plain", "cases": n_checked, "equal": True,
          "self_hit_score": self_score, "split_launches": split_launches,
          "k4_k5_cases": v1_launches, "k7_flagged_lanes": k7_flagged,
          "k3_segment_launches": k3_launches,
          "k3_self_hits_score_qend_tend": long_hits,
          "k6_launches": k6_launches,
          "seconds": time.perf_counter() - t0})

    # --- 3b. T1 and T2 against their plain versions -----------------------------
    # the batches of one full-mode query of 256 aa over the main database,
    # as `traceback.plan_batches` forms them: the shortest, the median and
    # the longest (42 pairs, B = 64, T_pad 1,920) at every algorithm at gaps
    # 3/1, the median at 1/3 (sw) and 0/0 (nw), the median's lengths over
    # the tie-heavy database's construction (seed 12, sw), and a random 32 x
    # 32 matrix over 32 symbols (nw); each T1 output byte-equal to the plain
    # version's (columns past each length are 0 in both), each T2 walk (buf,
    # i, j) equal on the same bytes, from the score pass's ends
    t0 = time.perf_counter()
    db_seqs, queries = main_workload()
    db = pt.Database(db_seqs)
    n_t = len(db)
    setup_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    tb_targets = [db.get_encoded(i) for i in range(n_t)]
    tb_q = np.frombuffer(db.alphabet.encode(queries[0]), np.uint8)
    tb_batches, tb_scalar = traceback.plan_batches(
        len(tb_q), [len(t) for t in tb_targets])
    if tb_scalar:
        fail(f"{len(tb_scalar)} main-database pairs over the cell budget")
    tb_picks = {"shortest": tb_batches[0],
                "median": tb_batches[len(tb_batches) // 2],
                "longest": tb_batches[-1]}
    tb_cases = {}
    tb_args = {}  # label -> (T1's arguments, T2's arguments)

    def tb_compare(label, q_enc, mat, tgts, batch, algo, gaps, q_ends,
                   t_ends):
        """T1 and T2 against their plain versions on one padded batch."""
        tgt, tlen = traceback.pad_batch(tgts, batch)
        qes, tes = traceback.walk_ends(tgts, batch, tgt.shape[0], len(q_enc),
                                       q_ends, t_ends, algo)
        prof = np.ascontiguousarray(
            np.asarray(mat, np.int32)[q_enc.astype(np.int64)])
        args = (torch.from_numpy(prof).to(dev), torch.from_numpy(tgt).to(dev),
                *gaps, algo, torch.from_numpy(tlen).to(dev))
        (dirs,), e1 = compare(
            "traceback_dirs", lambda *a: (traceback._dir_matrix_batch(*a),),
            lambda *a: (traceback.dir_matrix_reference(*a),), args,
            f"T1 {label}")
        t1_plain = plain_seconds["traceback_dirs"]
        wargs = (dirs, torch.from_numpy(qes).to(dev),
                 torch.from_numpy(tes).to(dev), algo)
        out, e2 = compare("traceback_walk", traceback._walk_batch_device,
                          traceback.walk_reference, wargs, f"T2 {label}")
        ops = int((out[0] != 255).sum())
        tb_cases[label] = {
            "B": int(tgt.shape[0]), "T_pad": int(tgt.shape[1]),
            "pairs": len(batch), "cells": int(tlen.sum()) * len(q_enc),
            "walk_ops": ops, "max_abs_err": max(e1, e2),
            "plain_seconds": [t1_plain, plain_seconds["traceback_walk"]]}
        tb_args[label] = (args, wargs)

    tb_gaps = [(a, (GO, GE)) for a in algos] + [("sw", (1, 3)),
                                                 ("nw", (0, 0))]
    with db.lock.read:
        tb_ends = {key: engine.search_scores(
            db, 0, n_t, tb_q, S, *key[1], key[0], device=dev)[1:]
            for key in tb_gaps}
    for name, batch in tb_picks.items():
        for algo in algos:
            tb_compare(f"{name} {algo} 3/1", tb_q, S, tb_targets, batch, algo,
                       (GO, GE), *tb_ends[algo, (GO, GE)])
    for algo, gaps in tb_gaps[4:]:
        tb_compare(f"median {algo} {gaps[0]}/{gaps[1]}", tb_q, S, tb_targets,
                   tb_picks["median"], algo, gaps, *tb_ends[algo, gaps])
    # the tie-heavy construction (phase 5e's) at the median batch's lengths
    trng = np.random.default_rng(12)
    motif = np.frombuffer(db.alphabet.encode("WCHKMY"), np.uint8)
    tie_seqs = []
    for i in tb_picks["median"]:
        L = len(tb_targets[i])
        t_ = np.resize(np.roll(motif, int(trng.integers(0, 6))), L)
        hit = trng.random(L) < 0.03
        t_[hit] = trng.integers(0, 20, int(hit.sum()))
        tie_seqs.append(db.alphabet.decode(t_.astype(np.uint8).tobytes()))
    tie_db = pt.Database(tie_seqs)
    tie_q = np.resize(motif, 256).astype(np.uint8)
    with tie_db.lock.read:
        _, tie_qe, tie_te = engine.search_scores(
            tie_db, 0, len(tie_db), tie_q, S, GO, GE, "sw", device=dev)
    tie_tg = [tie_db.get_encoded(i) for i in range(len(tie_db))]
    tb_compare("tie-heavy median sw 3/1", tie_q, S, tie_tg,
               list(range(len(tie_tg))), "sw", (GO, GE), tie_qe, tie_te)
    # a random 32 x 32 matrix (phase 3's) over 32 symbols: nw, whose end is
    # the terminal cell
    r32 = [rng.integers(0, 32, int(n)).astype(np.uint8)
           for n in rng.integers(1, 513, 64)]
    q32 = rng.integers(0, 32, 256).astype(np.uint8)
    tb_compare("random 32x32 nw 3/1", q32, m32, r32, list(range(64)), "nw",
               (GO, GE), np.full(64, 255), np.array([len(t) - 1 for t in r32]))
    # where the walks change hands: queries on either side of a T1 thread's
    # 8 rows, of its 256-row pass and of two passes; targets on either side
    # of its 32-column symbol tiles and of T2's 64-row, 64-column tiles,
    # each holding a stretch of the query; sw at 3/1 and nw at 3/1 (the
    # boundary rows) from the score pass's ends, and sw at -1/2 (outside
    # the engine's gaps) from each pair's terminal cell
    erng = np.random.default_rng(10)
    e_lens = [0, 1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255,
              256, 257, 300]
    for ql in (1, 15, 16, 17, 255, 256, 257, 511, 512, 513):
        e_q = erng.integers(0, 20, ql).astype(np.uint8)
        e_seqs = []
        for n in e_lens:
            t_ = erng.integers(0, 20, n).astype(np.uint8)
            k = min(n // 2, ql)
            t_[n // 4:n // 4 + k] = e_q[:k]
            e_seqs.append(db.alphabet.decode(t_.tobytes()))
        e_db = pt.Database(e_seqs)
        e_tg = [e_db.get_encoded(i) for i in range(len(e_db))]
        cases = [("sw", (GO, GE))]
        if ql in (17, 257, 513):
            cases += [("nw", (GO, GE)), ("sw", (-1, 2))]
        for algo, gaps in cases:
            if gaps[0] < 0:
                e_qe = np.full(len(e_lens), ql - 1)
                e_te = np.array(e_lens) - 1
            else:
                with e_db.lock.read:
                    _, e_qe, e_te = engine.search_scores(
                        e_db, 0, len(e_db), e_q, S, *gaps, algo, device=dev)
            tb_compare(f"edge Q={ql} {algo} {gaps[0]}/{gaps[1]}", e_q, S,
                       e_tg, list(range(len(e_tg))), algo, gaps, e_qe, e_te)
    emit({"phase": "traceback_vs_plain", "batches_per_query": len(tb_batches),
          "batch_sizes": {k: [tb_cases[f"{k} sw 3/1"][x] for x in
                              ("pairs", "B", "T_pad")] for k in tb_picks},
          "cases": len(tb_cases), "equal": True,
          "plain_seconds": {k: v["plain_seconds"] for k, v in
                            tb_cases.items()},
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
    letters = "ARNDCQEGHILKMFPSTWYV"
    residues = db.total_length
    emit({"phase": "main_setup", "targets": n_t, "residues": residues,
          "queries": len(queries), "query_length": 256,
          "seconds": setup_seconds})

    zero_counts()
    t0 = time.perf_counter()
    res_s = al.align_arrays(queries, db, mode="score")
    res_e = al.align_arrays(queries, db, mode="end")
    single = al.align(queries[0], db, mode="score")
    counts = launch_counts()
    first_seconds = time.perf_counter() - t0
    # K2 1 and K1 1 per align_arrays, K1 1 per align, each on its packed
    # walk in score mode and on its int32 walk in end mode
    if counts != only(ragged=1, ragged_packed=2, q8=1, q8_packed=1):
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

    # the oracle's pairs, chosen before any result is read: a seeded sample
    # of the main path, nw/hw/ov on a 1,000-target slice, and the long
    # queries of 5b against the shortest targets; worker processes score
    # them while the card runs the main path and the long-query path
    enc_q = [np.frombuffer(db.alphabet.encode(q), np.uint8) for q in queries]
    srng = np.random.default_rng(256)
    pairs = [(int(a), int(b)) for a, b in zip(
        srng.integers(0, 67, 256), srng.integers(0, n_t, 256))]
    lo = max(n_t // 2 - 1000, 0)
    hi = min(lo + 1000, n_t)
    slice_q = queries[:11]
    slice_pairs = {
        algo: [(int(a), int(b)) for a, b in zip(
            srng.integers(0, 11, 48), srng.integers(0, hi - lo, 48))]
        for algo in ("nw", "hw", "ov")
    }
    jobs = [(enc_q[a], db.get_encoded(b), S, GO, GE, "sw") for a, b in pairs]
    jobs += [(enc_q[a], db.get_encoded(lo + b), S, GO, GE, algo)
             for algo, ps in slice_pairs.items() for a, b in ps]
    lrng = np.random.default_rng(35000)
    long_q = {n: "".join(letters[i] for i in lrng.integers(0, 20, n))
              for n in (35000, 5000)}
    long_enc = {n: np.frombuffer(db.alphabet.encode(q), np.uint8)
                for n, q in long_q.items()}
    lengths_all = np.asarray(db.get_lengths())
    shortest = np.argsort(lengths_all, kind="stable")
    slice_short = lo + np.argsort(lengths_all[lo:hi], kind="stable")[:4]
    long_pairs = [(n, int(b), "sw") for n, k in ((35000, 16), (5000, 8))
                  for b in shortest[:k]]
    long_pairs += [(5000, int(b), algo) for algo in ("nw", "hw", "ov")
                   for b in slice_short]
    long_jobs = [(long_enc[n], db.get_encoded(b), S, GO, GE, algo)
                 for n, b, algo in long_pairs]

    import concurrent.futures as cf
    import multiprocessing

    # one core stays with this process, which drives the card
    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    pool = cf.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        long_oracle = pool.map(naive.score_end, *zip(*long_jobs), chunksize=1)
        main_oracle = pool.map(naive.score_end, *zip(*jobs), chunksize=8)

        zero_counts()
        t0 = time.perf_counter()
        res_s = al.align_arrays(queries, db, mode="score")
        res_e = al.align_arrays(queries, db, mode="end")
        single = al.align(queries[0], db, mode="score")
        counts = launch_counts()
        first_seconds = time.perf_counter() - t0
        if counts != only(ragged=1, ragged_packed=2, q8=1,
                          q8_packed=1):  # as above
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
        want = [(int(res_e["scores"][a, b]), int(res_e["query_ends"][a, b]),
                 int(res_e["target_ends"][a, b])) for a, b in pairs]
        for algo, ps in slice_pairs.items():
            out = al.align_arrays(slice_q, db, mode="end", algorithm=algo,
                                  start=lo, end=hi)
            want += [tuple(int(out[k][a, b]) for k in
                           ("scores", "query_ends", "target_ends"))
                     for a, b in ps]

        # --- 5b. the long-query path at full size -----------------------------
        # the 5,000-residue query: K1 at its fine tier, on the packed route
        # in score mode (min(5,120, 1,827) x 15 lies within int16)
        want_launches = {35000: only(ragged_long=18), 5000: only(ragged=1)}
        want_packed = {35000: want_launches[35000],
                       5000: only(ragged_packed=1)}
        zero_counts()
        t0 = time.perf_counter()
        long_res, long_times = {}, {}
        for n, q in long_q.items():
            for mode in ("end", "score"):
                before = launch_counts()
                t1 = time.perf_counter()
                long_res[n, mode] = al.align(q, db, mode=mode)
                long_times[n, mode] = [time.perf_counter() - t1]
                got = {k: v - before[k] for k, v in launch_counts().items()}
                if got != (want_packed if mode == "score"
                           else want_launches)[n]:
                    fail(f"{n}-residue align({mode!r}) launches: {got}")
        long_counts = launch_counts()
        long_seconds = time.perf_counter() - t0
        long_arrays = {}
        for n in long_q:
            hits = long_res[n, "end"]
            arr = np.array(
                [[r.score, r.query_end, r.target_end] for r in hits],
                np.int64).T
            if arr.shape != (3, n_t):
                fail(f"{n}-residue align: shape {arr.shape}")
            if [r.score for r in long_res[n, "score"]] != arr[0].tolist():
                fail(f"{n}-residue align: score mode and end mode disagree")
            if arr[0].min() < 0 or arr[1].max() >= n:
                fail(f"{n}-residue align: scores or ends out of range")
            long_arrays[n] = arr

        # the plain versions on the 1,000-target slice
        t1 = time.perf_counter()
        fps = packing.pack_database_slice_flat(db, lo, hi)
        flat_s, inv_s = dev_flat(fps), engine._flat_device(fps, dev)[5]
        k3_plain = ragged_long.search_flat_long_reference(
            long_enc[35000], S, *flat_s, GO, GE, "sw", True, fps.chunk)
        profs = torch.from_numpy(ragged.make_profiles_host(
            [long_enc[5000]], S, q_pad=ragged.fine_qpad(5000))).to(dev)
        k1_plain = [x[0] for x in ragged.search_flat_reference(
            profs, torch.tensor([5000], dtype=torch.int32, device=dev),
            *flat_s, GO, GE, "sw", True, fps.chunk, True)]
        for n, planes in ((35000, k3_plain), (5000, k1_plain)):
            plain = torch.stack([x.reshape(-1) for x in planes])
            plain = plain.index_select(1, inv_s).cpu().numpy()
            if not np.array_equal(plain, long_arrays[n][:, lo:hi]):
                fail(f"{n}-residue align differs from the plain version on "
                     f"targets {lo}..{hi}")
        slice_plain_seconds = time.perf_counter() - t1
        long_want = []
        for algo in ("nw", "hw", "ov"):
            out = al.align_arrays([long_q[5000]], db, mode="end",
                                  algorithm=algo, start=lo, end=hi)
            long_want += [tuple(int(out[k][0, b - lo]) for k in
                                ("scores", "query_ends", "target_ends"))
                          for b in slice_short]
        long_want = [tuple(int(x) for x in long_arrays[n][:, b])
                     for n, b, algo in long_pairs if algo == "sw"] + long_want

        t1 = time.perf_counter()
        for name, js, ws, got in (("sampled", jobs, want, main_oracle),
                                  ("long-query", long_jobs, long_want,
                                   long_oracle)):
            bad = [(j[5], w, tuple(g)) for j, w, g in zip(js, ws, got)
                   if tuple(w) != tuple(g)]
            if bad:
                fail(f"{len(bad)} of {len(js)} {name} pairs differ from the "
                     f"oracle, e.g. {bad[:3]}")
        oracle_wait = time.perf_counter() - t1
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    emit({"phase": "main_path", "launches": counts,
          "first_calls_seconds": first_seconds,
          "oracle_pairs": len(jobs), "oracle_equal": True})
    emit({"phase": "long_query_path", "launches": long_counts,
          **{f"{n} {m} seconds": t[0] for (n, m), t in long_times.items()},
          "seconds": long_seconds, "plain_slice_targets": [lo, hi],
          "plain_equal": True, "plain_seconds": slice_plain_seconds,
          "oracle_pairs": len(long_jobs), "oracle_equal": True,
          "oracle_wait_seconds": oracle_wait,
          "best_35000_sw": int(long_arrays[35000][0].max())})

    # --- 5g. the I/O path at full size --------------------------------------
    # the main database written as FASTA (60 residues a line), read back
    # with the C scanner and with the Python fallback, saved and loaded as
    # an archive, then searched as the main path searches it, counted from
    # 0: one `align` (K1) and `align_arrays` in both modes (K2 and K1 each)
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_io_") as io_dir:
        fasta_path = os.path.join(io_dir, "main.fasta")
        with open(fasta_path, "wb") as f:
            for i, seq in enumerate(db_seqs):
                f.write(b">t%d synthetic\n" % i)
                raw = seq.encode("ascii")
                f.write(b"\n".join(raw[j:j + 60]
                                   for j in range(0, len(raw), 60)) + b"\n")
        io_seconds = {}
        with Timer(0, 0) as t:
            names, fasta_db = pt.read_fasta(fasta_path)
        io_seconds["read_fasta_c"] = t.seconds
        with open(fasta_path, "rb") as f:
            data = f.read()
        with Timer(0, 0) as t:
            py_names, py_seqs = io_mod._parse_fasta_py(data, db.alphabet)
        io_seconds["read_fasta_python"] = t.seconds
        if names != py_names or len(py_seqs) != n_t or any(
                not np.array_equal(s_, fasta_db.get_encoded(i))
                for i, s_ in enumerate(py_seqs)):
            fail("read_fasta: the C scanner and the Python fallback differ")
        with Timer(0, 0) as t:
            pt.save_database(os.path.join(io_dir, "main"), fasta_db, names)
        io_seconds["save_database"] = t.seconds
        with Timer(0, 0) as t:
            loaded_names, loaded = pt.load_database(
                os.path.join(io_dir, "main"))
        io_seconds["load_database"] = t.seconds
        archive_bytes = os.path.getsize(os.path.join(io_dir, "main.npz"))
        fasta_bytes = os.path.getsize(fasta_path)
    if loaded_names != [f"t{i}" for i in range(n_t)] or any(
            not np.array_equal(loaded.get_encoded(i), db.get_encoded(i))
            for i in range(n_t)):
        fail("load_database: the archive differs from the main database")
    zero_counts()
    io_single = al.align(queries[0], loaded, mode="score")
    io_s = al.align_arrays(queries, loaded, mode="score")
    io_e = al.align_arrays(queries, loaded, mode="end")
    io_counts = launch_counts()
    if io_counts != only(ragged=1, ragged_packed=2, q8=1, q8_packed=1):
        fail(f"I/O path launches: {io_counts}")
    if any(type(r) is not results_mod.ScoreResult for r in io_single):
        fail("the loaded database's align built no C ScoreResult")
    if [(r.target_index, r.score) for r in io_single] != [
            (r.target_index, r.score) for r in single]:
        fail("align on the loaded database differs from the main database")
    if not np.array_equal(io_s["scores"], res_s["scores"]) or any(
            not np.array_equal(io_e[k], res_e[k]) for k in res_e):
        fail("align_arrays on the loaded database differs from the main "
             "database")
    emit({"phase": "io_path", "launches": io_counts, "targets": n_t,
          "fasta_bytes": fasta_bytes, "archive_bytes": archive_bytes,
          **{f"{k}_seconds": v for k, v in io_seconds.items()},
          "equal": True, "seconds": time.perf_counter() - t0, **card})

    # --- 5c. the sharded path at full size ----------------------------------

    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = tmp_dir.name

    def start_ranks(backend, world):
        """``world`` processes of this script, one rank each."""
        init = os.path.join(tmp, f"{backend}{world}.init")
        outs = [os.path.join(tmp, f"{backend}{world}_{r}.npz")
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--world", str(world), "--backend", backend, "--init", init,
             "--out", outs[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        return backend, procs, outs

    def finish_ranks(started, timeout=300):
        """Wait for the ranks, hold each one's result against the single
        process's, and describe each rank."""
        backend, procs, outs = started
        deadline = time.monotonic() + timeout
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks = []
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                fail(f"{backend} rank {r} exited {p.returncode}:\n"
                     f"{logs[r][-3000:]}")
            z = np.load(out)
            for key in ("scores", "query_ends", "target_ends"):
                if not np.array_equal(z[key], res_e[key]):
                    fail(f"{backend} rank {r}: {key} differ from align_arrays")
            if 2 * int(z["local_bytes"]) > int(z["total_bytes"]):
                fail(f"{backend} rank {r} packed more than its shards")
            ranks.append({
                "rank": r, "device": str(z["device"]),
                "local_shards": z["local_shards"].tolist(),
                "local_payload_bytes": int(z["local_bytes"]),
                "all_payload_bytes": int(z["total_bytes"]),
                "call_seconds": float(z["seconds"]),
                "setup_seconds": float(z["setup_seconds"])})
        return ranks

    gloo_ranks = start_ranks("gloo", 2)  # runs beside the phases below
    mesh4 = device_mesh(4)
    gq = enc_q[0]
    with db.lock.read:
        gpack = packing.pack_database_slice(db, 0, n_t)
    t0 = time.perf_counter()
    zero_counts()
    sh_s = align_arrays_sharded(queries, db, mode="score", mesh=mesh4)
    sh_e = align_arrays_sharded(queries, db, mode="end", mesh=mesh4)
    # the grouped pack through K6 on the 4 shards, one 256-residue query
    g_planes = np.zeros((3, n_t), np.int32)
    for g in gpack.groups:
        t_pad4, l_pad4 = sharded.pad_blocks(g.targets, g.lengths, 4)
        planes = sharded.sharded_search_group(
            mesh4, (group.make_profile_host(gq, S), len(gq)), t_pad4, l_pad4,
            GO, GE, "sw", with_ends=True)
        idx = g.indices.reshape(-1)
        for k, plane in enumerate(planes):
            g_planes[k, idx[idx >= 0]] = plane.reshape(-1)[: idx.size][
                idx >= 0]
    sharded_counts = launch_counts()
    sharded_seconds = time.perf_counter() - t0
    # K1 a shard a call: on its packed route in score mode
    want_sharded = only(ragged=4, ragged_packed=4, q8=2 * 4,
                        group=4 * len(gpack.groups))
    if sharded_counts != want_sharded:
        fail(f"sharded path launches: {sharded_counts}, want {want_sharded}")
    if not np.array_equal(sh_s["scores"], res_s["scores"]) or any(
            not np.array_equal(sh_e[k], res_e[k]) for k in res_e):
        fail("align_arrays_sharded differs from align_arrays")
    hits = al.align(queries[0], db, mode="end")
    want_g = np.array([[r.score, r.query_end, r.target_end] for r in hits],
                      np.int64).T
    if not np.array_equal(g_planes, want_g):
        bad = np.nonzero((g_planes != want_g).any(0))[0]
        fail(f"K6 over the grouped pack differs from align on {bad.size} "
             f"targets, e.g. {bad[:5].tolist()}")
    top_k = 25
    pad = (-n_t) % 4
    sc = np.concatenate([g_planes[0], np.full(pad, -(2**31), np.int32)])
    ix = np.concatenate([np.arange(n_t, dtype=np.int32),
                         np.full(pad, -1, np.int32)])
    tv, ti = sharded.top_k_merge(mesh4, sc, ix, top_k)
    order = np.argsort(-sc.astype(np.int64), kind="stable")[:top_k]
    if not (np.array_equal(tv, sc[order]) and np.array_equal(ti, ix[order])):
        fail(f"top_k_merge: {tv.tolist()} {ti.tolist()}")
    # K6 against its plain version at every launch the path made: each
    # group's 4 shard runs, the same tensors sharded_search_group builds
    gq_prof = group.make_profile_host(gq, S)
    k6_path_args = []
    for g in gpack.groups:
        t_pad4, l_pad4 = sharded.pad_blocks(g.targets, g.lengths, 4)
        per = t_pad4.shape[0] // 4
        for s_, d in enumerate(mesh4.devices):
            k6_path_args.append((
                (torch.from_numpy(gq_prof).to(d), len(gq)),
                torch.from_numpy(t_pad4[s_ * per:(s_ + 1) * per]).to(d),
                torch.from_numpy(l_pad4[s_ * per:(s_ + 1) * per]).to(d),
                GO, GE, "sw", True))
    k6_path_errs, k6_path_plain_s = [], 0.0
    for i, args in enumerate(k6_path_args):
        _, err = compare("group", group.search_group,
                         group.search_group_reference, args,
                         f"K6 sharded path launch {i}")
        k6_path_errs.append(err)
        k6_path_plain_s += plain_seconds["group"]

    # a one-rank nccl group, then the two gloo ranks (and two nccl ranks
    # where there are two cards)
    t1 = time.perf_counter()
    initialize_distributed("nccl", f"file://{tmp}/nccl1.init", 1, 0)
    try:
        nccl1 = align_arrays_sharded(queries, db, mode="end",
                                     mesh=device_mesh(2))
    finally:
        torch.distributed.destroy_process_group()
    nccl1_seconds = time.perf_counter() - t1
    if any(not np.array_equal(nccl1[k], res_e[k]) for k in res_e):
        fail("the one-rank nccl group differs from align_arrays")
    groups_run = {"nccl, 1 rank, 2 shards": {"seconds": nccl1_seconds},
                  "gloo, 2 ranks on one card, 2 shards each":
                      finish_ranks(gloo_ranks)}
    if torch.cuda.device_count() >= 2:
        groups_run["nccl, 2 ranks on 2 cards, 2 shards each"] = finish_ranks(
            start_ranks("nccl", 2))
    else:
        groups_run["nccl, 2 ranks on 2 cards"] = "not run: one card"
    tmp_dir.cleanup()
    emit({"phase": "sharded_path", "mesh": [str(d) for d in mesh4.devices],
          "launches": sharded_counts, "k6_groups": len(gpack.groups),
          "seconds": sharded_seconds, "equal_to_align_arrays": True,
          "k6_equal_to_align": True,
          "k6_launches_equal_to_plain": len(k6_path_args),
          "k6_launches_plain_seconds": k6_path_plain_s, "top_k": top_k,
          "top_k_scores": tv.tolist(), "process_groups": groups_run,
          **card})

    # --- 5d. the path without safe_pad at full size ---------------------------
    # `sharded_search_flat` at its defaults (K4 or K5 on each of 4 shards),
    # the engine's route for a 32-column matrix (K4, K5, K3), and K7 on the
    # main path's q8 groups; each call counted from 0
    t0 = time.perf_counter()
    new_counts, new_seconds = {}, {}

    def counted_call(key, want, fn):
        zero_counts()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        new_seconds[key] = time.perf_counter() - t1
        new_counts[key] = launch_counts()
        if new_counts[key] != want:
            fail(f"{key} launches: {new_counts[key]}, want {want}")
        return out

    def same(a, b, what):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            bad = np.nonzero(np.asarray(a) != np.asarray(b))
            fail(f"{what}: {len(bad[0])} values differ")

    xrng = np.random.default_rng(3000)
    x_q = {n: "".join(letters[i] for i in xrng.integers(0, 20, n))
           for n in (1000, 3000)}
    x_enc = {n: np.frombuffer(db.alphabet.encode(q), np.uint8)
             for n, q in x_q.items()}
    sf4 = sfm.pack_flat_sharded([db.get_encoded(i) for i in range(n_t)], 4)

    def sharded_flat(queries_enc, algo, ends, **kw):
        return sfm.sharded_search_flat(
            mesh4, ragged.make_profiles_host(queries_enc, S),
            np.array([len(q) for q in queries_enc], np.int32), sf4, GO, GE,
            algo, ends, **kw)

    for ends in (True, False):
        k4 = counted_call(f"sharded_search_flat 3 x 256 aa ends={ends}",
                          only(ragged_v1=4),
                          lambda: sharded_flat(enc_q[:3], "sw", ends))
        k1 = sharded_flat(enc_q[:3], "sw", ends, safe_pad=True)
        for k, (a, b) in enumerate(zip(k4, k1)):
            if ends or k == 0:
                same(a, b, f"sharded K4 ends={ends} plane {k} vs K1")
            elif (a != -1).any():  # sw's score planes: -1 in K4 as in K1
                fail("sharded K4 sw score planes are not -1")
        same(k4[0], res_s["scores"][:3], "sharded K4 scores vs align_arrays")
    k4 = counted_call("sharded_search_flat 1 x 256 aa nw score",
                      only(ragged_v1=4),
                      lambda: sharded_flat(enc_q[:1], "nw", False))
    k1 = sharded_flat(enc_q[:1], "nw", False, safe_pad=True)
    same(k4[0], k1[0], "sharded K4 nw scores vs K1")
    same(k4[1], np.full((1, n_t), 255), "sharded K4 nw score-mode q_end")
    same(k4[2], (lengths_all - 1)[None], "sharded K4 nw score-mode t_end")
    k1_long = {}
    for n in (1000, 3000):
        k5 = counted_call(f"sharded_search_flat {n} aa score",
                          only(ragged_strip=4),
                          lambda: sharded_flat([x_enc[n]], "sw", False))
        k1_long[n] = sharded_flat([x_enc[n]], "sw", False, safe_pad=True)
        same(k5[0], k1_long[n][0], f"sharded K5 {n} aa scores vs K1")
        if (k5[1] != -1).any() or (k5[2] != -1).any():
            fail(f"sharded K5 {n} aa planes are not -1")

    # BLOSUM50's 24 x 24 block inside a 32 x 32 matrix, -4 elsewhere: the
    # database's codes are below 24, so the answers are BLOSUM50's
    S32 = np.full((32, 32), -4, np.int32)
    S32[: S.shape[0], : S.shape[1]] = S
    with db.lock.read:
        def route32(queries_enc, ends):
            return engine.search_scores_batch(
                db, 0, n_t, queries_enc, S32, GO, GE, "sw", ends, device=dev)

        e32 = {ends: counted_call(
            f"engine 32-column 67 x 256 aa ends={ends}", only(ragged_v1=1),
            lambda: route32(enc_q, ends)) for ends in (False, True)}
        e1000 = counted_call("engine 32-column 1000 aa end",
                             only(ragged_v1=1),
                             lambda: route32([x_enc[1000]], True))
        s3000 = counted_call("engine 32-column 3000 aa score",
                             only(ragged_strip=1),
                             lambda: route32([x_enc[3000]], False))
        e3000 = counted_call("engine 32-column 3000 aa end",
                             only(ragged_long=2),
                             lambda: route32([x_enc[3000]], True))
    same(e32[False][0], res_s["scores"], "32-column score route vs main path")
    for k, key in enumerate(("scores", "query_ends", "target_ends")):
        same(e32[True][k], res_e[key], f"32-column end route {key}")
    hits = al.align(x_q[1000], db, mode="end")
    same(np.stack(e1000)[:, 0],
         np.array([[r.score, r.query_end, r.target_end] for r in hits]).T,
         "32-column 1000 aa end (K4) vs Aligner.align (K1)")
    same(s3000[0], k1_long[3000][0], "32-column 3000 aa score (K5) vs K1")
    same(e3000[0], s3000[0], "32-column 3000 aa end (K3) vs score (K5)")
    k3_plain = ragged_long.search_flat_long_reference(
        x_enc[3000], S32, *flat_s, GO, GE, "sw", True, fps.chunk)
    k3_plain = torch.stack([x.reshape(-1) for x in k3_plain])
    same(np.stack(e3000)[:, 0, lo:hi],
         k3_plain.index_select(1, inv_s).cpu().numpy(),
         "32-column 3000 aa end (K3) vs its plain version on the slice")

    # K7 on the main path's 8 q8 groups, one query the first 256 residues
    # of a database sequence, so that its lane reaches the cap
    (_, lanes_q8, groups, _), = engine.plan_tier_launches(enc_q, True)
    enc7 = list(enc_q)
    enc7[groups[0][0]] = db.get_encoded(int(np.argmax(lengths_all >= 256)))[
        :256].copy()
    fpw = packing.pack_database_slice_flat(db, 0, n_t, lanes=lanes_q8)
    k7_in = tuple(torch.from_numpy(a).to(dev) for a in q8.make_profiles_q8_host(
        enc7, S, groups[:8], lanes=lanes_q8))
    k7_args = (*k7_in, *dev_flat(fpw), GO, GE, "sw", False, fpw.chunk, True)
    k7 = counted_call("K7 8 groups", only(q8_narrow=1),
                      lambda: q8.search_flat_q8(*k7_args))
    k2 = q8.search_flat_q8(*k7_args[:-1])
    if not torch.equal(k7[0], k2[0].clamp(max=q8.NARROW_CAP)):
        fail("K7 scores are not min(K2, 255) on the main path's groups")
    if (k7[1] != -1).any() or (k7[2] != -1).any():
        fail("K7 end planes are not -1")
    k7_main_flagged = int((k7[0] == q8.NARROW_CAP).sum())
    if k7_main_flagged < 1:
        fail("K7 flagged no lane on the main path's groups")
    counted_call("K2 packed 8 groups", only(q8_packed=1),
                 lambda: k2_packed("main 8 groups", k7_args[:-1], k2))
    x_counts = {k: sum(c[k] for c in new_counts.values()) for k in counters}
    emit({"phase": "no_safe_pad_path", "launches": new_counts,
          "seconds_per_call": new_seconds,
          "k7_flagged_lanes": k7_main_flagged,
          "k7_lanes": int(k7[0].numel()),
          "equal": True, "seconds": time.perf_counter() - t0, **card})

    # --- 5e. K1-K7 at the walk's pass boundaries, full width ----------------
    # query lengths on either side of a thread's 16 rows and of a pass
    # (64, 128 and 256 rows at G = 4, 8 and 16), through several passes,
    # against the main database; and a tie-heavy database of 12,071
    # repeated-motif sequences at the main database's lengths searched
    # with motif queries, where equal maxima fall in different threads,
    # passes and columns
    t0 = time.perf_counter()
    fp_full = packing.pack_database_slice_flat(db, 0, n_t)
    mrng = np.random.default_rng(12)
    motif = np.frombuffer(db.alphabet.encode("WCHKMY"), np.uint8)
    tie_t = []
    for L in lengths_all:
        t_ = np.resize(np.roll(motif, int(mrng.integers(0, 6))), int(L))
        hit = mrng.random(int(L)) < 0.03
        t_[hit] = mrng.integers(0, 20, int(hit.sum()))
        tie_t.append(t_.astype(np.uint8))
    fp_tie = packing.pack_sequences_flat(tie_t)

    def edge_query(n, stretch=True):
        q = mrng.integers(0, 20, n).astype(np.uint8)
        if stretch:  # a high-scoring stretch of a database sequence
            src = db.get_encoded(int(np.argmax(lengths_all >= 200)))
            q[3:63] = src[100:160]
        return q

    def tie_query(n):
        return np.resize(motif, n).astype(np.uint8)

    modes = (("sw", False), ("sw", True), ("nw", True), ("hw", True),
             ("ov", True))
    edge_cases = {"K1": {}, "K3": {}}
    for label, fpk, qs in (
        ("tier 64 (G 4): 16, 17, 63, 64", fp_full,
         [edge_query(16, False), edge_query(17, False), edge_query(63),
          edge_query(64)]),
        ("tier 128 (G 8): 65, 127, 128", fp_full,
         [edge_query(65), edge_query(127), edge_query(128)]),
        ("tier 1024 (G 16): 255, 256, 257, 515", fp_full,
         [edge_query(n) for n in (255, 256, 257, 515)]),
        ("tie-heavy 259, 515", fp_tie, [tie_query(259), tie_query(515)]),
    ):
        profs = torch.from_numpy(ragged.make_profiles_host(qs, S)).to(dev)
        qlens = torch.tensor([len(q) for q in qs], dtype=torch.int32,
                             device=dev)
        for algo, ends in modes:
            before = ragged.launches["ragged"]
            compare("ragged", ragged.search_flat,
                    ragged.search_flat_reference,
                    (profs, qlens, *dev_flat(fpk), GO, GE, algo, ends,
                     fpk.chunk, True), f"{label} {algo} ends={ends}")
            if ragged.launches["ragged"] != before + 1:
                fail(f"K1 {label}: not one launch")
            edge_cases["K1"][f"{label} {algo} ends={ends}"] = 1
    # K3: 2048 + 515 rows (8 passes, then 3 ending inside a thread)
    for label, fpk, q, ms_ in (
        ("2563 rows", fp_full, edge_query(2563), modes),
        ("tie-heavy 2563 rows", fp_tie, tie_query(2563),
         (("sw", True), ("ov", True))),
    ):
        for algo, ends in ms_:
            n, _ = compare_segments(q, fpk, algo, ends, ragged_long.QSEG,
                                    label)
            if n != 2:
                fail(f"K3 {label}: {n} launches, want 2")
            edge_cases["K3"][f"{label} {algo} ends={ends}"] = n
    # K2: q8 groups whose slots end on either side of a thread's 16 rows
    # and of a pass (G = 4, 8, 16 at tiers 64, 128, 256; two passes at
    # 512), a short group (empty slots) at 64; then motif queries on the
    # tie-heavy database, equal maxima across slots, threads and passes
    fpw_full = packing.pack_database_slice_flat(db, 0, n_t, lanes=512)
    fpw_tie = packing.pack_sequences_flat(tie_t, lanes=512)
    edge_cases["K2"] = {}
    for label, fpk, qs, ms_ in (
        ("tier 64: 16, 17, 63, 64 and 4 empty slots", fpw_full,
         [edge_query(16, False), edge_query(17, False), edge_query(63),
          edge_query(64)], modes),
        ("tier 128: 65-128", fpw_full,
         [edge_query(n) for n in (65, 127, 128, 66, 96, 100, 111, 112)],
         modes),
        ("tier 256: 129-256", fpw_full,
         [edge_query(n) for n in (255, 256, 129, 130, 191, 192, 240, 254)],
         modes),
        ("tier 512 (two passes): 257-512", fpw_full,
         [edge_query(n) for n in (257, 511, 512, 258, 272, 300, 383, 384)],
         modes),
        ("tie-heavy tier 512: 259-512", fpw_tie,
         [tie_query(n) for n in (259, 512, 260, 300, 333, 400, 500, 511)],
         (("sw", True), ("ov", True))),
    ):
        groups = q8.plan_groups([len(q) for q in qs])
        k2e = tuple(torch.from_numpy(a).to(dev) for a in
                    q8.make_profiles_q8_host(qs, S, groups, lanes=512))
        for algo, ends in ms_:
            before = q8.launches["q8"]
            compare("q8", q8.search_flat_q8, q8.search_flat_q8_reference,
                    (*k2e, *dev_flat(fpk), GO, GE, algo, ends, fpk.chunk),
                    f"K2 {label} {algo} ends={ends}")
            if q8.launches["q8"] != before + 1:
                fail(f"K2 {label}: not one launch")
            edge_cases["K2"][f"{label} {algo} ends={ends}"] = 1
    # K7: pairs of slots whose lengths straddle a thread's 16 rows and a
    # pass (16/17, 255/256, 511/512: each pair walks its longer slot's
    # rows), a group of 7 queries (slot 7 empty beside slot 6), a group of
    # self-hits (stretches of database sequences, past the cap), and motif
    # queries on the tie-heavy database; each against its plain version
    # and min(K2's, 255), one launch a call
    edge_cases["K7"] = {}
    hits = [db.get_encoded(int(i))[:n].copy() for i, n in zip(
        np.nonzero(lengths_all >= 300)[0][:8],
        (256, 250, 240, 200, 180, 160, 140, 130))]
    for label, fpk, qs, gaps_list in (
        ("pairs 512/511, 256/255, 17/16", fpw_full,
         [edge_query(n) for n in (512, 511, 256, 255)]
         + [edge_query(17, False), edge_query(16, False)],
         ((GO, GE), (0, 0), (255, 255))),
        ("7 queries, tier 128", fpw_full,
         [edge_query(n) for n in (128, 120, 100, 90, 80, 70, 65)],
         ((GO, GE),)),
        ("self-hits, tier 256", fpw_full, hits,
         ((GO, GE), (0, 0), (255, 255))),
        ("tie-heavy tier 512: 259-512", fpw_tie,
         [tie_query(n) for n in (259, 512, 260, 300, 333, 400, 500, 511)],
         ((GO, GE), (0, 0))),
    ):
        groups = q8.plan_groups([len(q) for q in qs])
        k7e = tuple(torch.from_numpy(a).to(dev) for a in
                    q8.make_profiles_q8_host(qs, S, groups, lanes=512))
        for gaps in gaps_list:
            args = (*k7e, *dev_flat(fpk), *gaps, "sw", False, fpk.chunk)
            before = q8.launches["q8_narrow"]
            out, _ = compare("q8_narrow", q8.search_flat_q8,
                             q8.search_flat_q8_reference, (*args, True),
                             f"K7 {label} gaps={gaps}")
            if q8.launches["q8_narrow"] != before + 1:
                fail(f"K7 {label}: not one launch")
            exact = q8.search_flat_q8(*args)[0]
            if not torch.equal(out[0], exact.clamp(max=q8.NARROW_CAP)):
                fail(f"K7 {label} gaps={gaps}: scores are not min(K2, 255)")
            edge_cases["K7"][f"{label} gaps={gaps}"] = int(
                (out[0] == q8.NARROW_CAP).sum())
    if min(v for k, v in edge_cases["K7"].items() if "self-hits" in k) < 8:
        fail(f"K7's self-hits flagged too few lanes: {edge_cases['K7']}")
    # K5: 2,560-2,563 rows at the 4096 tier (a pass ends at row 2,560;
    # the walk stops in the pass that holds row Q - 1), every algorithm;
    # then a negative gap, which walks all 4,096 rows (the pad rows count
    # for sw and ov)
    edge_cases["K5"] = {}
    k5_q = {n: edge_query(n) for n in (2560, 2561, 2562, 2563)}
    for algo, gaps, lens_ in (
        [("sw", (GO, GE), (2560, 2561, 2562, 2563))]
        + [(a, (GO, GE), (2560, 2563)) for a in ("nw", "hw", "ov")]
        + [("sw", (-1, 2), (2560, 2561, 2562, 2563)),
           ("ov", (-1, 2), (2560, 2563))]
    ):
        profs = torch.from_numpy(ragged.make_profiles_host(
            [k5_q[n] for n in lens_], S)).to(dev)
        qlens = torch.tensor(lens_, dtype=torch.int32, device=dev)
        before = ragged.launches["ragged_strip"]
        compare("ragged_strip", ragged.search_flat,
                ragged.search_flat_reference,
                (profs, qlens, *dev_flat(fp_full), *gaps, algo, False,
                 fp_full.chunk, False), f"K5 {lens_} {algo} gaps={gaps}")
        if ragged.launches["ragged_strip"] != before + 1:
            fail(f"K5 {lens_} {algo} gaps={gaps}: not one launch")
        edge_cases["K5"][f"{lens_} {algo} gaps={gaps}"] = 1
    # K4 (no safe_pad): queries on either side of a thread's 16 rows (G 4
    # at the 64 tier), at the 256-row pass, and through two passes of the
    # 512 tier (end mode: score mode there is K5's), at 3/1 (rows [0, Q))
    # and -1/2 (every row, the pad rows tracked with ends); motif queries
    # on the tie-heavy database
    edge_cases["K4"] = {}
    for label, fpk, qs, ms_ in (
        ("tier 64: 16, 17", fp_full,
         [edge_query(16, False), edge_query(17, False)], modes),
        ("tier 256: 255, 256", fp_full,
         [edge_query(255), edge_query(256)], modes),
        ("tier 512 (two passes): 257, 511, 512", fp_full,
         [edge_query(n) for n in (257, 511, 512)], modes[1:]),
        ("tie-heavy tier 512: 259, 512", fp_tie,
         [tie_query(259), tie_query(512)], (("sw", True), ("ov", True))),
    ):
        profs = torch.from_numpy(ragged.make_profiles_host(qs, S)).to(dev)
        qlens = torch.tensor([len(q) for q in qs], dtype=torch.int32,
                             device=dev)
        for algo, ends in ms_:
            for gaps in ((GO, GE), (-1, 2)):
                before = ragged.launches["ragged_v1"]
                compare("ragged_v1", ragged.search_flat,
                        ragged.search_flat_reference,
                        (profs, qlens, *dev_flat(fpk), *gaps, algo, ends,
                         fpk.chunk, False),
                        f"K4 {label} {algo} ends={ends} gaps={gaps}")
                if ragged.launches["ragged_v1"] != before + 1:
                    fail(f"K4 {label}: not one launch")
                edge_cases["K4"][f"{label} {algo} ends={ends} gaps={gaps}"] = 1
    # K6: one query over each database stacked as one group (12,160
    # lanes, every block at the longest t_pad): queries of 17 and 20
    # residues (Q_pad 24, G 2) and 260 (Q_pad 264, two passes), not
    # multiples of 16, where at -1/2 the masked final pass holds row
    # Q - 1; 256 (one pass) and 512 (two passes); tie-heavy queries on
    # the tie-heavy database
    k6_full = stacked_group(gpack)
    k6_tie = stacked_group(packing.pack_sequences(tie_t))
    edge_cases["K6"] = {}
    for label, (tgt_, len_), qs, ms_ in (
        ("17, 20, 256", k6_full,
         [edge_query(17, False), edge_query(20, False), edge_query(256)],
         (("sw", False), ("sw", True), ("ov", True))),
        ("260, 512", k6_full, [edge_query(260), edge_query(512)], modes),
        ("tie-heavy 260, 512", k6_tie, [tie_query(260), tie_query(512)],
         (("sw", True), ("ov", True))),
    ):
        for q in qs:
            pq = group.make_profile(q, S, dev)
            for algo, ends in ms_:
                for gaps in ((GO, GE), (-1, 2)):
                    before = group.launches
                    compare("group", group.search_group,
                            group.search_group_reference,
                            (pq, tgt_, len_, *gaps, algo, ends),
                            f"K6 {len(q)} {algo} ends={ends} gaps={gaps}")
                    if group.launches != before + 1:
                        fail(f"K6 {label}: not one launch")
                    edge_cases["K6"][
                        f"{len(q)} {algo} ends={ends} gaps={gaps}"] = 1
    emit({"phase": "wave_edges", "cases": edge_cases, "equal": True,
          "targets": n_t, "seconds": time.perf_counter() - t0, **card})

    # --- 5f. full mode and top-k at full width -------------------------------
    # one 256-aa query through Aligner.align(mode="full") against every
    # target (K1, then T1 and T2 once per batch), equal to end mode and, on
    # 16 pairs of spread lengths, to the oracle's traceback; the first 8
    # queries (one q8 group, K2) through align_arrays(mode="full") against
    # align_batch's objects; align_top_k(k=100) for the 67 queries, and
    # align_top_k_sharded over the 4 shards equal to it (plus a case whose
    # ties force the second candidate gather); align_arrays_sharded(mode=
    # "full") of 3 queries against align_arrays; the golden values in full
    # mode.  The counts are set to 0 before the first call and read after
    # the last.
    t0 = time.perf_counter()
    full_lens = np.sort(lengths_all[lengths_all < 1500])
    oracle_b = [int(np.nonzero(lengths_all == full_lens[int(k)])[0][0])
                for k in np.linspace(0, full_lens.size - 1, 16)]
    oracle_jobs = [(enc_q[0], db.get_encoded(b), S, GO, GE, "sw")
                   for b in oracle_b]

    def full_rows(hits):
        return [(h.target_index, h.score, h.query_start, h.query_end,
                 h.target_start, h.target_end, h.alignment) for h in hits]

    pool = cf.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        oracle_full = pool.map(naive.traceback, *zip(*oracle_jobs),
                               chunksize=1)
        zero_counts()
        t1 = time.perf_counter()
        full = al.align(queries[0], db, mode="full")
        full_call_seconds = time.perf_counter() - t1
        full_one = launch_counts()
        want_one = only(ragged=1, traceback_dirs=len(tb_batches),
                        traceback_walk=len(tb_batches))
        if full_one != want_one:
            fail(f"align(mode='full') launches: {full_one}, want {want_one}")
        if len(full) != n_t:
            fail(f"align(mode='full') returned {len(full)} results")
        same(np.array([[h.score, h.query_end, h.target_end] for h in full]).T,
             np.stack([res_e[k][0] for k in
                       ("scores", "query_ends", "target_ends")]),
             "align(mode='full') vs end mode")
        # align_arrays(mode="full") of one q8 group against align_batch
        t1 = time.perf_counter()
        arr8 = al.align_arrays(queries[:8], db, mode="full")
        arrays_seconds = time.perf_counter() - t1
        obj8 = al.align_batch(queries[:8], db, mode="full")
        for key in ("scores", "query_ends", "target_ends"):
            same(arr8[key], res_e[key][:8], f"align_arrays(full) {key}")
        for qi, hits in enumerate(obj8):
            for key, attr in (("scores", "score"), ("query_ends", "query_end"),
                              ("target_ends", "target_end"),
                              ("query_starts", "query_start"),
                              ("target_starts", "target_start")):
                same(arr8[key][qi], [getattr(h, attr) for h in hits],
                     f"align_arrays(full) {key} vs align_batch, query {qi}")
            if list(arr8["cigars"][qi]) != [h.cigar() for h in hits]:
                fail(f"align_arrays(full) CIGARs vs align_batch, query {qi}")
        if full_rows(obj8[0]) != full_rows(full):  # query 0 both times
            fail("align_batch(full) differs from align(full)")
        # top-k for the 67 queries, single device and over the 4 shards
        t1 = time.perf_counter()
        top = [al.align_top_k(q, db, k=100) for q in queries]
        top_seconds = time.perf_counter() - t1
        for qi, hits in enumerate(top):
            order = np.argsort(-res_e["scores"][qi], kind="stable")[:100]
            same([h.target_index for h in hits], order,
                 f"align_top_k order, query {qi}")
            same([[h.score, h.query_end, h.target_end] for h in hits],
                 np.stack([res_e[k][qi][order] for k in
                           ("scores", "query_ends", "target_ends")]).T,
                 f"align_top_k ends, query {qi}")
        full_list = full_rows(full)
        if full_rows(top[0]) != [full_list[h.target_index] for h in top[0]]:
            fail("align_top_k differs from align(full) on its hits")
        gathers = []
        real_candidates = sfm.sharded_topk_candidates

        def counted_candidates(*args):
            gathers.append(args[-1])
            return real_candidates(*args)

        sfm.sharded_topk_candidates = counted_candidates
        try:
            t1 = time.perf_counter()
            top_sh = align_top_k_sharded(queries, db, k=100, mesh=mesh4)
            top_sh_seconds = time.perf_counter() - t1
            main_gathers = list(gathers)
            if [full_rows(h) for h in top_sh] != [full_rows(h) for h in top]:
                fail("align_top_k_sharded differs from align_top_k")
            # ties straddling every shard's candidate floor
            # (tests/test_sharded_api.py's construction)
            import random

            trand = random.Random(17)
            base = "".join(trand.choice(letters) for _ in range(40))
            tie_targets = [base] * 120 + [
                "".join(trand.choice(letters)
                        for _ in range(trand.randint(10, 80)))
                for _ in range(80)]
            trand.shuffle(tie_targets)
            tdb = pt.Database(tie_targets)
            del gathers[:]
            tie_sh = align_top_k_sharded([base], tdb, k=15, mesh=mesh4)[0]
            tie_gathers = list(gathers)
        finally:
            sfm.sharded_topk_candidates = real_candidates
        if full_rows(tie_sh) != full_rows(al.align_top_k(base, tdb, k=15)):
            fail("align_top_k_sharded differs from align_top_k on ties")
        # the main queries' first gather takes each shard's 100 best; a
        # second (every shard's whole list) only where ties at the 100th
        # score straddle a shard's floor
        if len(tie_gathers) != 2 or main_gathers[0] != 100 or len(
                main_gathers) > 2:
            fail(f"candidate gathers: {main_gathers}, ties {tie_gathers}")
        t1 = time.perf_counter()
        arr3 = align_arrays_sharded(queries[:3], db, mode="full", mesh=mesh4)
        arrays_sh_seconds = time.perf_counter() - t1
        want3 = al.align_arrays(queries[:3], db, mode="full")
        if arr3.keys() != want3.keys():
            fail(f"align_arrays_sharded(full) keys: {sorted(arr3)}")
        for key in want3:
            same(arr3[key], want3[key], f"align_arrays_sharded(full) {key}")
        # the golden values in full mode
        (nwf,) = al.align("ACCTCG", gdb, mode="full", algorithm="nw")
        (swf,) = al.align("ACCTCG", gdb, mode="full", algorithm="sw")
        golden_full = [nwf.score, nwf.cigar(), swf.score, swf.target_start]
        if golden_full != [44, "1D5M1D1M", 47, 1]:
            fail(f"golden values in full mode: {golden_full}")
        full_counts = launch_counts()
        for k in ("ragged", "q8", "traceback_dirs", "traceback_walk"):
            if full_counts[k] < 1:
                fail(f"the full-mode path launched no {k}: {full_counts}")
        t1 = time.perf_counter()
        for b, o in zip(oracle_b, oracle_full):
            h = full[b]
            got = (h.score, h.query_start, h.target_start, h.query_end,
                   h.target_end, h.cigar())
            if got != (*o[:5], cigar_string(o[5])):
                fail(f"align(mode='full') target {b}: {got}, oracle {o[:5]} "
                     f"{cigar_string(o[5])}")
        oracle_full_wait = time.perf_counter() - t1
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    emit({"phase": "full_mode_path", "launches": full_counts,
          "align_full_launches": full_one, "batches": len(tb_batches),
          "align_full_seconds": full_call_seconds,
          "align_arrays_full_8_seconds": arrays_seconds,
          "align_top_k_67_seconds": top_seconds,
          "align_top_k_sharded_67_seconds": top_sh_seconds,
          "align_arrays_sharded_full_3_seconds": arrays_sh_seconds,
          "candidate_gathers": main_gathers, "tie_gathers": tie_gathers,
          "oracle_pairs": len(oracle_b),
          "oracle_lengths": [int(lengths_all[b]) for b in oracle_b],
          "oracle_wait_seconds": oracle_full_wait, "golden": golden_full,
          "equal": True, "seconds": time.perf_counter() - t0, **card})

    # --- 6. timings and kernels against plain versions at main shapes ----------
    enc = enc_q
    plan = engine.plan_tier_launches(enc, safe_pad=True)
    (tier, lanes_q8, groups, v2_idx), = plan
    fpw = packing.pack_database_slice_flat(db, 0, n_t, lanes=lanes_q8)
    fp = packing.pack_database_slice_flat(db, 0, n_t)
    k2_in = engine._profiles_q8(enc, S, groups, lanes_q8, dev)
    k1_in = engine._profiles_for_cohort([enc[i] for i in v2_idx], S, dev)
    k1_single = engine._profiles_for_cohort([enc[0]], S, dev)
    k1_fine = (
        torch.from_numpy(ragged.make_profiles_host(
            [long_enc[5000]], S, q_pad=ragged.fine_qpad(5000))).to(dev),
        torch.tensor([5000], dtype=torch.int32, device=dev),
    )
    shapes = {
        "q8": (q8.search_flat_q8, q8.search_flat_q8_reference,
               (*k2_in, *dev_flat(fpw)), fpw,
               sum(len(enc[i]) for g in groups for i in g)),
        "ragged": (ragged.search_flat, ragged.search_flat_reference,
                   (*k1_in, *dev_flat(fp)), fp,
                   sum(len(enc[i]) for i in v2_idx)),
        "ragged_single": (ragged.search_flat, ragged.search_flat_reference,
                          (*k1_single, *dev_flat(fp)), fp, len(enc[0])),
        "ragged_fine": (ragged.search_flat, ragged.search_flat_reference,
                        (*k1_fine, *dev_flat(fp)), fp, 5000),
    }

    def time_launches(fn, args, n, warm=True):
        if warm:
            fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(*args)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / n

    #: instructions per cell and their rate a SM a clock, by walk: the
    #: plain int32 loop, the wavefront walk's DPX-fused cell (K1-K6) and
    #: its packed s16x2 form, two cells an instruction (K7)
    walks = {"int32": (OPS_PER_CELL_SW_SCORE, INT32_LANES_PER_SM),
             "wave": (OPS_PER_CELL_WAVE, wave_lanes),
             "narrow": (OPS_PER_PAIR_NARROW / 2, narrow_rate),
             "pair": (OPS_PER_PAIR_K1_PACKED / 2, narrow_rate)}

    def bound(cells, n_bytes, walk="wave"):
        """The least time of ``cells`` DP cells of ``walk`` and ``n_bytes``
        moved, with the plain int32 bound beside it as ``int32_bound_ms``
        and, for the packed walk (K7), K2's wave bound on the same cells
        as ``k2_wave_bound_ms``."""
        ops, lanes = walks[walk]
        ops_ms = ops * cells / (N_SMS * lanes * max_sm_mhz * 1e6) * 1e3
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        out = {"ops": ops * cells, "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
        if walk != "int32":
            out["int32_bound_ms"] = bound(cells, n_bytes, "int32")["bound_ms"]
        if walk == "narrow":
            out["k2_wave_bound_ms"] = bound(cells, n_bytes)["bound_ms"]
        if walk == "pair":
            out["k1_wave_bound_ms"] = bound(cells, n_bytes)["bound_ms"]
        return out

    results = {}
    for key, (kfn, pfn, base, fpk, query_rows) in shapes.items():
        # the fine tier's ends were held against the plain version in
        # phases 3 and 5b; a launch takes seconds there, so its score-mode
        # comparison is its warm-up and two launches are timed
        fine = key == "ragged_fine"
        errs = []
        for ends in (False,) if fine else (True, False):
            args = (*base, GO, GE, "sw", ends, fpk.chunk)
            if key != "q8":
                args += (True,)  # safe_pad: K1
            out, err = compare(key, kfn, pfn, args, f"main shape ends={ends}")
            errs.append(err)
        ms = time_launches(kfn, args, 2 if fine else 3, warm=not fine)
        plain_ms = plain_seconds[key] * 1e3  # the score-mode comparison's
        cells = query_rows * residues
        out_bytes = 3 * 4 * out[0].numel()
        in_bytes = (fpk.flat_targets.size + fpk.lengths.nbytes
                    + sum(t.numel() * t.element_size() for t in base[:3]))
        q_pad = base[0].shape[1] // (q8.QB if key == "q8" else 1)
        results[key] = {
            "ms": ms, "plain_ms": plain_ms, "max_abs_err": max(errs),
            "cells": cells, "gcups": cells / (ms * 1e-3) / 1e9,
            "bytes": in_bytes + out_bytes,
            **bound(cells, in_bytes + out_bytes),
            # the walk: threads per target, rows per thread
            "wave": {"G": ragged.wave_group(q_pad), "R": ragged.WAVE_R},
        }
        emit({"phase": "kernel_timing", "kernel": key, "mode": "sw score",
              **results[key], **card})

    # K1's packed route at K1's main shapes (the cohort and the single
    # query, sw score): held against the plain version, its scores K1's,
    # timed beside K1 in the same run; its bound counts 6.5 packed
    # instructions for two cells
    t_max = int(fp.lengths.max())
    for key, base, query_rows in (
            ("ragged_packed", k1_in, sum(len(enc[i]) for i in v2_idx)),
            ("ragged_packed_single", k1_single, len(enc[0]))):
        q_pad = base[0].shape[1]
        cap = engine._ragged_packed_cap("sw", False, GO, GE, m_abs, q_pad,
                                        t_max, True, base[0].shape[0],
                                        fp.lengths.size)
        if cap is None:
            fail(f"{key}: the engine does not admit the main shape")

        def packed(*a):
            return ragged.search_flat(*a, packed_cap=cap)

        args = (*base, *dev_flat(fp), GO, GE, "sw", False, fp.chunk, True)
        out, err = compare(key, packed, ragged.search_flat_reference, args,
                           "main shape ends=False")
        if not all(torch.equal(a, b) for a, b in
                   zip(out, ragged.search_flat(*args))):
            fail(f"{key}: differs from K1's int32 walk")
        ms = time_launches(packed, args, 3)
        cells = query_rows * residues
        n_bytes = (fp.flat_targets.size + fp.lengths.nbytes + 3 * 4
                   * out[0].numel() + sum(t.numel() * t.element_size()
                                          for t in base))
        results[key] = {
            "ms": ms, "k1_ms": time_launches(ragged.search_flat, args, 3),
            "plain_ms": plain_seconds[key] * 1e3, "max_abs_err": err,
            "cells": cells, "gcups": cells / (ms * 1e-3) / 1e9,
            "bytes": n_bytes, "cap": cap, **bound(cells, n_bytes, "pair"),
            "wave": {"G": ragged.wave_group(q_pad), "R": ragged.WAVE_R},
        }
        emit({"phase": "kernel_timing", "kernel": key, "mode": "sw score",
              **results[key], **card})

    # K4, K5 and K7 at the shapes of phase 5d's calls (K4: the engine's
    # 67 x 256-aa cohort under the 32-column matrix; K5: the 3,000-residue
    # query at the 4096 tier; K7: the 8 q8 groups): each against its plain
    # version on the 1,000-target slice (K4 in both modes) and on the whole
    # database in score mode (the plain time), then timed.  Cells (and the
    # bound) count the query rows the function needs; K5's walk stops at
    # the pass that holds row 2,999 (12 passes of 256 rows of the 4096
    # tier's 16, the TPU kernel walks all 4,096), reported apart as walked
    # cells.  K4 and K5 run the wavefront walk, K7 its packed form, timed
    # beside K2 on the same groups.
    fps512 = packing.pack_database_slice_flat(db, lo, hi, lanes=lanes_q8)
    walked_rows = {"ragged_strip": -(-3000 // 256) * 256}
    new_shapes = {  # name: (inputs, packs, query rows, modes on the slice)
        "ragged_v1": (
            (torch.from_numpy(ragged.make_profiles_host(enc, S32)).to(dev),
             torch.tensor([len(q) for q in enc], dtype=torch.int32,
                          device=dev)),
            (fp, fps), 256 * len(enc), (True, False)),
        "ragged_strip": (
            (torch.from_numpy(ragged.make_profiles_host(
                [x_enc[3000]], S32)).to(dev),
             torch.tensor([3000], dtype=torch.int32, device=dev)),
            (fp, fps), 3000, (False,)),
        "q8_narrow": (
            k7_in, (fpw, fps512),
            sum(len(enc7[i]) for g in groups[:8] for i in g), (False,)),
        "q8_packed": (
            k7_in, (fpw, fps512),
            sum(len(enc7[i]) for g in groups[:8] for i in g), (False,)),
    }
    for key, (base, (fpk, fps_k), query_rows, modes) in new_shapes.items():
        extra = {  # narrow (K7), packed_cap (K2's packed route), safe_pad
            "q8_narrow": (True,),
            "q8_packed": (False, tier * int(np.abs(S).max())),
        }.get(key, (False,))
        kfn, pfn = ((q8.search_flat_q8, q8.search_flat_q8_reference)
                    if key.startswith("q8") else
                    (ragged.search_flat, ragged.search_flat_reference))
        errs = []
        for ends in modes:
            _, err = compare(key, kfn, pfn, (
                *base, *dev_flat(fps_k), GO, GE, "sw", ends, fps_k.chunk,
                *extra), f"1,000-target slice ends={ends}")
            errs.append(err)
        args = (*base, *dev_flat(fpk), GO, GE, "sw", False, fpk.chunk, *extra)
        out, err = compare(key, kfn, pfn, args, "main shape, score mode")
        errs.append(err)
        ms = time_launches(kfn, args, 3)
        cells = query_rows * residues
        out_bytes = 3 * 4 * out[0].numel()
        in_bytes = (fpk.flat_targets.size + fpk.lengths.nbytes
                    + sum(t.numel() * t.element_size() for t in base))
        narrow = key.startswith("q8")  # the packed walk
        results[key] = {
            "ms": ms, "plain_ms": plain_seconds[key] * 1e3,
            "max_abs_err": max(errs), "cells": cells,
            "gcups": cells / (ms * 1e-3) / 1e9,
            "bytes": in_bytes + out_bytes,
            **bound(cells, in_bytes + out_bytes,
                    "narrow" if narrow else "wave"),
            # the walk: threads per target (pair of slots for K7), rows each
            "wave": {"G": ragged.wave_group(
                base[0].shape[1] // (q8.QB if narrow else 1)),
                "R": ragged.WAVE_R},
        }
        if narrow:  # K2 on the same groups, the same run
            results[key]["k2_ms"] = time_launches(
                kfn, args[:-len(extra)], 3)
        if key in walked_rows:
            walked = walked_rows[key] * residues
            results[key].update(walked_cells=walked,
                                walked_gcups=walked / (ms * 1e-3) / 1e9)
        emit({"phase": "kernel_timing", "kernel": key, "mode": "sw score",
              **results[key], **card})

    # K3: the second 2048-row segment of the 35,000-residue query at full
    # width, its state from the first; the plain time is that of the
    # score-mode comparison's plain run
    qseg = ragged_long.QSEG
    prof = torch.from_numpy(ragged.make_profiles_host(
        [long_enc[35000][:2 * qseg]], S, q_pad=2 * qseg)[0]).to(dev)
    flat = dev_flat(fp)
    zeros = torch.zeros(flat[0].shape, dtype=torch.int32, device=dev)
    trk0 = torch.zeros((ragged_long.N_TRACK, *fp.lengths.shape[::2]),
                       dtype=torch.int32, device=dev)
    errs = []
    for ends in (True, False):
        seg0 = ragged_long.search_segment(
            prof[:qseg], 35000, 0, *flat, zeros,
            torch.full_like(zeros, ragged_long.NEG), trk0, GO, GE, "sw", ends,
            fp.chunk)
        args = (prof[qseg:], 35000, qseg, *flat, *seg0[3:], GO, GE, "sw",
                ends, fp.chunk)
        out, err = compare("ragged_long", ragged_long.search_segment,
                           ragged_long.segment_reference, args,
                           f"35,000-residue segment 1 ends={ends}")
        errs.append(err)
    ms = time_launches(ragged_long.search_segment, args, 3, warm=False)
    cells = qseg * residues
    n_bytes = (fp.flat_targets.size + fp.lengths.nbytes
               + prof.numel() * 2  # the segment's half of the profile
               + 4 * sum(t.numel() for t in (*args[8:11], *out)))
    results["ragged_long"] = {
        "ms": ms, "plain_ms": plain_seconds["ragged_long"] * 1e3,
        "max_abs_err": max(errs + k3_errs), "cells": cells,
        "gcups": cells / (ms * 1e-3) / 1e9,
        "bytes": n_bytes, **bound(cells, n_bytes),
        "per_call_bound_ms": bound(35000 * residues, 18 * n_bytes)["bound_ms"],
        "wave": {"G": ragged.wave_group(qseg), "R": ragged.WAVE_R},
    }
    emit({"phase": "kernel_timing", "kernel": "ragged_long",
          "mode": "sw score, one 2048-row segment", **results["ragged_long"],
          **card})

    # K6 as the sharded path launches it: one query, 40 launches (each
    # length bucket's 4 shard runs, end mode), held against the plain
    # version above; then the whole database stacked as one group (every
    # block at the longest t_pad: one launch over all 12,160 lanes) and
    # one launch per group, unsharded
    pq = group.make_profile(gq, S, dev)

    def k6_path():
        for args in k6_path_args:
            group.search_group(*args)

    path_ms = time_launches(k6_path, (), 3)
    # the same launches with none of the host's time between them: a sleep
    # kernel holds the stream while the host queues all of them, then the
    # events time the card alone (valid while the queueing is the shorter)
    hold_ms = 100.0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_ms * 1e-3 * max_sm_mhz * 1e6))
    t1 = time.perf_counter()
    start.record()
    for _ in range(3):
        k6_path()
    stop.record()
    queue_ms = (time.perf_counter() - t1) * 1e3
    torch.cuda.synchronize()
    path_device_ms = start.elapsed_time(stop) / 3
    if queue_ms >= hold_ms:
        path_device_ms = None  # the host fell behind: not a device time
    cells = len(gq) * residues
    # residues read once (the kernel stops at each length), lengths,
    # profile, three output planes
    path_lanes = sum(a[2].numel() for a in k6_path_args)
    path_bytes = (residues + 4 * path_lanes
                  + len(k6_path_args) * pq[0].numel() * 4 + 3 * 4 * path_lanes)
    path_bound = bound(cells, path_bytes)

    full_l = k6_full[1]  # phase 5e's stacked group
    base = (pq, *k6_full, GO, GE, "sw")
    errs = []
    for ends in (True, False):
        out, err = compare("group", group.search_group,
                           group.search_group_reference, (*base, ends),
                           f"K6 whole database ends={ends}")
        errs.append(err)
    ms = time_launches(group.search_group, (*base, False), 3)
    gdev = [(torch.from_numpy(g.targets).to(dev),
             torch.from_numpy(g.lengths).to(dev)) for g in gpack.groups]

    def k6_groups():
        for t_, l_ in gdev:
            group.search_group(pq, t_, l_, GO, GE, "sw", False)

    groups_ms = time_launches(k6_groups, (), 3)
    n_bytes = (residues + 4 * full_l.numel() + pq[0].numel() * 4
               + 3 * 4 * full_l.numel())
    stacked_bound = bound(cells, n_bytes)
    results["group"] = {
        "ms": path_ms, "plain_ms": k6_path_plain_s * 1e3,
        "max_abs_err": max(errs + k6_path_errs), "cells": cells,
        "gcups": cells / (path_ms * 1e-3) / 1e9,
        "bytes": path_bytes, **path_bound,
        "shape": f"one {len(gq)}-aa query, sw end mode, the sharded path's "
                 f"{len(k6_path_args)} launches ({path_lanes} lanes); ms, "
                 "plain_ms and bound_ms are per query over those launches",
        "path_device_ms": path_device_ms, "path_queue_ms": queue_ms / 3,
        "stacked_ms": ms, "stacked_plain_ms": plain_seconds["group"] * 1e3,
        "stacked_bound_ms": stacked_bound["bound_ms"],
        "wave": {"G": ragged.wave_group(pq[0].shape[0]), "R": ragged.WAVE_R},
        "stacked_gcups": cells / (ms * 1e-3) / 1e9,
        "stacked_lanes": full_l.numel(),
        "stacked_t_pad": k6_full[0].shape[1],
        "per_group_ms": groups_ms, "per_group_launches": len(gdev),
        "per_group_gcups": cells / (groups_ms * 1e-3) / 1e9,
    }
    emit({"phase": "kernel_timing", "kernel": "group",
          "mode": "sw, 256 aa x the database: the sharded path's launches "
                  "(end mode); stacked as one group and per group (score "
                  "mode)", **results["group"], **card})

    def wall(fn, n, warm=True):
        if warm:
            fn()
        times = []
        for _ in range(n):
            t1 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t1)
        return times

    def counted(fn):
        """Launches of each kernel during one call of ``fn``."""
        zero_counts()
        fn()
        return launch_counts()

    def split_single_align(n=5):
        """One 256-aa `align` in ``n`` calls, each timed with `Timer`:
        K1 by CUDA events around its launch, the result building by the
        host clock, the rest of the call; then the C and the Python
        builders on the same arrays (query 0's scores and ends)."""
        real_launch, real_build = _cuda.launch, engine.build_score_results
        k1_events, build_s, call_s = [], [], []

        def k1_timed(name, *a):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            real_launch(name, *a)
            stop.record()
            k1_events.append((name, start, stop))

        def build_timed(*a):
            t1 = time.perf_counter()
            out = real_build(*a)
            build_s.append(time.perf_counter() - t1)
            return out

        _cuda.launch, engine.build_score_results = k1_timed, build_timed
        try:
            for _ in range(n):
                with Timer(len(enc[0]), residues) as t:
                    one()
                call_s.append(t.seconds)
        finally:
            _cuda.launch, engine.build_score_results = real_launch, real_build
        torch.cuda.synchronize()
        if ([e[0] for e in k1_events] != ["ragged_packed"] * n
                or len(build_s) != n):
            fail(f"align split: launches {[e[0] for e in k1_events]} and "
                 f"{len(build_s)} builds in {n} calls")
        k1_s = [a.elapsed_time(b) * 1e-3 for _, a, b in k1_events]
        arrays = {"score": (res_s["scores"][0],),
                  "end": tuple(res_e[k][0] for k in
                               ("scores", "query_ends", "target_ends"))}
        builders = {
            "score": (results_mod.build_score_results,
                      results_mod._py_build_score_results),
            "end": (results_mod.build_end_results,
                    results_mod._py_build_end_results),
        }
        builder_s = {}
        for mode, (c_fn, py_fn) in builders.items():
            c_out, py_out = c_fn(0, *arrays[mode]), py_fn(0, *arrays[mode])
            if [r.__reduce__()[1] for r in c_out] != [
                    r.__reduce__()[1] for r in py_out]:
                fail(f"the C and Python {mode} builders differ")
            for name, fn in (("c", c_fn), ("python", py_fn)):
                times = []
                for _ in range(n):
                    with Timer(0, 0) as t:
                        fn(0, *arrays[mode])
                    times.append(t.seconds)
                builder_s[f"{mode}_{name}_seconds"] = times
        return {
            "call_seconds": call_s, "gcups": [
                len(enc[0]) * residues / c / 1e9 for c in call_s],
            "k1_seconds": k1_s, "build_results_seconds": build_s,
            "rest_seconds": [c - k - b for c, k, b in
                             zip(call_s, k1_s, build_s)],
            "hits": n_t, **builder_s,
        }

    def batch():
        return al.align_arrays(queries, db, mode="score")

    def one():
        return al.align(queries[0], db, mode="score")

    def batch_sharded():
        return align_arrays_sharded(queries, db, mode="score", mesh=mesh4)

    gdev4 = [tuple(torch.from_numpy(a).to(dev) for a in
                   sharded.pad_blocks(g.targets, g.lengths, 4))
             for g in gpack.groups]

    def group_sharded():  # one query, K6 on the 4 shards, every group
        for t_, l_ in gdev4:
            sharded.sharded_search_group(mesh4, pq, t_, l_, GO, GE, "sw",
                                         with_ends=True)

    batch_launches = counted(batch)
    single_launches = counted(one)
    batch_sharded_launches = counted(batch_sharded)
    group_sharded_launches = counted(group_sharded)
    batch_s = wall(batch, 3)
    batch_sharded_s = wall(batch_sharded, 3)
    group_sharded_s = wall(group_sharded, 3)
    single_s = wall(one, 5)
    align_split = split_single_align()
    cells_batch = sum(len(q) for q in enc) * residues
    # three calls of each long align: the end and score calls of phase 5b
    # and more end calls (one of the 35,000-residue query, ~15 s each)
    for n, q in long_q.items():
        long_times[n, "end"] += wall(lambda: al.align(q, db, mode="end"),
                                     1 if n == 35000 else 2, warm=False)
    emit({"phase": "end_to_end", "align_arrays_seconds": batch_s,
          "align_arrays_gcups": cells_batch / float(np.median(batch_s)) / 1e9,
          "align_arrays_launches": batch_launches,
          "align_arrays_sharded_4_shards_seconds": batch_sharded_s,
          "align_arrays_sharded_4_shards_gcups":
              cells_batch / float(np.median(batch_sharded_s)) / 1e9,
          "align_arrays_sharded_4_shards_launches": batch_sharded_launches,
          "sharded_search_group_4_shards_ms":
              [t * 1e3 for t in group_sharded_s],
          "sharded_search_group_4_shards_launches": group_sharded_launches,
          "single_align_ms": [t * 1e3 for t in single_s],
          "single_align_launches": single_launches,
          **{f"align_{n}_{m}_seconds": t for (n, m), t in long_times.items()},
          **{f"align_{n}_end_gcups":
             n * residues / float(np.median(long_times[n, "end"])) / 1e9
             for n in long_q}, **card})
    emit({"phase": "align_split", **align_split, **card})

    # T1 and T2 over the batches of one full-mode query (phase 5f's: 256 aa,
    # sw, gaps 3/1), each launch timed alone, three launches queued behind a
    # sleep on the card so that the host's time to issue them stays out;
    # then the parts of align(mode="full"): the score pass (K1), the batched
    # traceback (host batching and refinement around T1 and T2) and the
    # result building
    t0 = time.perf_counter()
    prof0 = torch.from_numpy(np.ascontiguousarray(
        S[enc_q[0].astype(np.int64)])).to(dev)
    qe0, te0 = tb_ends["sw", (GO, GE)]

    def time_queued(fn, args, n=3, hold_ms=5.0):
        """Device ms per launch of ``n`` launches queued behind a sleep of
        ``hold_ms``; None when the host took longer to queue them."""
        fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_ms * 1e-3 * max_sm_mhz * 1e6))
        t1 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn(*args)
        stop.record()
        queued = (time.perf_counter() - t1) * 1e3
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / n if queued < hold_ms else None

    def t1_bound(cells, n_bytes):
        ops = OPS_PER_CELL_DIRS * cells
        ops_ms = ops / (N_SMS * INT32_LANES_PER_SM * max_sm_mhz * 1e6) * 1e3
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        return {"ops": ops, "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}

    def t2_bound(steps):
        return {"bound_ms": steps * 32 / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes"}

    t1_ms, t2_ms, t_cells, t_bytes, w_ops = [], [], 0, 0, 0
    tb_rows = []  # per batch
    for batch in tb_batches:
        tgt, tlen = traceback.pad_batch(tb_targets, batch)
        qes, tes = traceback.walk_ends(tb_targets, batch, tgt.shape[0],
                                       len(enc_q[0]), qe0, te0, "sw")
        a1 = (prof0, torch.from_numpy(tgt).to(dev), GO, GE, "sw",
              torch.from_numpy(tlen).to(dev))
        t1_ms.append(time_queued(traceback._dir_matrix_batch, a1))
        dirs = traceback._dir_matrix_batch(*a1)
        a2 = (dirs, torch.from_numpy(qes).to(dev),
              torch.from_numpy(tes).to(dev), "sw")
        t2_ms.append(time_queued(traceback._walk_batch_device, a2))
        ops = traceback._walk_batch_device(*a2)[0] != 255  # (LMAX, B)
        n_ops = int(ops.sum())
        # a walk's steps: up to its last op (a final stop step emits none)
        last = ops.shape[0] - ops.flip(0).int().argmax(0)
        longest = int((last * ops.any(0)).max())
        cells = int(tlen.sum()) * len(enc_q[0])
        n_bytes = cells + 4 * tgt.size
        w_ops += n_ops
        t_cells += cells
        t_bytes += n_bytes
        tb_rows.append({
            "B": int(tgt.shape[0]), "T_pad": int(tgt.shape[1]),
            "pairs": len(batch), "t1_ms": t1_ms[-1], "t2_ms": t2_ms[-1],
            "t1_bound_ms": t1_bound(cells, n_bytes)["bound_ms"],
            "t2_bound_ms": t2_bound(n_ops)["bound_ms"],
            "walk_ops": n_ops, "longest_walk_steps": longest,
            "t2_cycles_per_step": (t2_ms[-1] * 1e-3 * max_sm_mhz * 1e6
                                   / longest if t2_ms[-1] and longest
                                   else None)})
    del dirs
    if None in t1_ms or None in t2_ms:
        fail("the host fell behind the queued T1/T2 launches")
    emit({"phase": "traceback_batches", "batches": tb_rows,
          "t1_threads_per_pair": traceback.dirs_group(len(enc_q[0])),
          "t1_rows_per_thread": traceback.DIRS_R,
          "t2_tile_rows_columns": list(traceback.WALK_TILE),
          "clock_mhz": max_sm_mhz, **card})

    parts = {"score_pass": 0.0, "traceback": 0.0}
    real_scores, real_batch = engine.search_scores, \
        traceback.full_alignments_batch

    def timed(key, fn):
        def run(*a, **kw):
            t1 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                parts[key] += time.perf_counter() - t1
        return run

    engine.search_scores = timed("score_pass", real_scores)
    traceback.full_alignments_batch = timed("traceback", real_batch)
    try:
        full_calls = wall(lambda: al.align(queries[0], db, mode="full"), 3,
                          warm=False)
    finally:
        engine.search_scores = real_scores
        traceback.full_alignments_batch = real_batch
    n_calls = len(full_calls)
    call_s = sum(full_calls) / n_calls
    dev_t = (sum(t1_ms) + sum(t2_ms)) * 1e-3
    full_split = {
        "call_seconds": full_calls,
        "score_pass_seconds": parts["score_pass"] / n_calls,
        "traceback_seconds": parts["traceback"] / n_calls,
        "results_seconds": call_s - (parts["score_pass"]
                                     + parts["traceback"]) / n_calls,
        "t1_seconds": sum(t1_ms) * 1e-3, "t2_seconds": sum(t2_ms) * 1e-3,
        "traceback_host_seconds": parts["traceback"] / n_calls - dev_t,
        "t1_share": sum(t1_ms) * 1e-3 / call_s,
        "t2_share": sum(t2_ms) * 1e-3 / call_s,
    }
    full_split["host_share"] = 1 - (dev_t + results["ragged_single"]["ms"]
                                    * 1e-3) / call_s
    long_label = "longest sw 3/1"
    lb = tb_cases[long_label]
    results["traceback_dirs"] = {
        "ms": t1_ms[-1], "plain_ms": lb["plain_seconds"][0] * 1e3,
        "max_abs_err": max(c["max_abs_err"] for c in tb_cases.values()),
        "cells": lb["cells"], **t1_bound(lb["cells"], lb["cells"] + 4 * lb[
            "B"] * lb["T_pad"]),
        "ops_per_cell": OPS_PER_CELL_DIRS,
        "shape": f"the longest batch of one 256-aa full-mode query (sw): "
                 f"B {lb['B']}, T_pad {lb['T_pad']}, {lb['pairs']} pairs; "
                 "query_ms over all its batches",
        "query_ms": sum(t1_ms), "query_launches": len(t1_ms),
        "query_bound_ms": t1_bound(t_cells, t_bytes)["bound_ms"],
        "per_batch_ms": t1_ms,
    }
    results["traceback_walk"] = {
        "ms": t2_ms[-1], "plain_ms": lb["plain_seconds"][1] * 1e3,
        "max_abs_err": max(c["max_abs_err"] for c in tb_cases.values()),
        "walk_steps": lb["walk_ops"], **t2_bound(lb["walk_ops"]),
        "shape": "the same batch; path steps counted as the ops emitted; "
                 "query_ms over all its batches",
        "query_ms": sum(t2_ms), "query_launches": len(t2_ms),
        "query_bound_ms": t2_bound(w_ops)["bound_ms"],
        "per_batch_ms": t2_ms,
    }
    for key in ("traceback_dirs", "traceback_walk"):
        emit({"phase": "kernel_timing", "kernel": key,
              "mode": "sw full, 256 aa x the database",
              **{k: v for k, v in results[key].items()
                 if k != "per_batch_ms"}, **card})
    emit({"phase": "full_mode_timing", **full_split,
          "t1_per_batch_ms": t1_ms, "t2_per_batch_ms": t2_ms,
          "cells": t_cells, "walk_ops": w_ops,
          "seconds": time.perf_counter() - t0, **card})

    # --- 7. the kernels line, the card line, the result line ----------------
    # launches: the runs of the main path, the long-query path and the
    # sharded path, each counted from 0
    entries = [
        ("q8", "pyopal_tpu_torch/csrc/q8.cu",
         "pyopal_tpu/ops/pallas_q8.py:138"),
        ("ragged", "pyopal_tpu_torch/csrc/ragged.cu",
         "pyopal_tpu/ops/pallas_ragged.py:400"),
        ("ragged_long", "pyopal_tpu_torch/csrc/ragged_long.cu",
         "pyopal_tpu/ops/pallas_ragged_long.py:49"),
        ("group", "pyopal_tpu_torch/csrc/group.cu",
         "pyopal_tpu/ops/pallas_kernel.py:119"),
        ("ragged_v1", "pyopal_tpu_torch/csrc/ragged_v1.cu",
         "pyopal_tpu/ops/pallas_ragged.py:169"),
        ("ragged_strip", "pyopal_tpu_torch/csrc/ragged_strip.cu",
         "pyopal_tpu/ops/pallas_ragged.py:732"),
        ("q8_narrow", "pyopal_tpu_torch/csrc/q8_narrow.cu",
         "pyopal_tpu/ops/pallas_q8.py:180"),
        ("q8_packed", "pyopal_tpu_torch/csrc/q8_narrow.cu",
         "pyopal_tpu/ops/pallas_q8.py:138"),
        ("ragged_packed", "pyopal_tpu_torch/csrc/ragged_packed.cu",
         "pyopal_tpu/ops/pallas_ragged.py:400"),
        ("traceback_dirs", "pyopal_tpu_torch/csrc/traceback_dirs.cu",
         "pyopal_tpu/ops/traceback.py:53"),
        ("traceback_walk", "pyopal_tpu_torch/csrc/traceback_walk.cu",
         "pyopal_tpu/ops/traceback.py:197"),
    ]
    kernels = []
    for name, source, replaces in entries:
        key = name
        launches = sum(c[name] for c in (counts, long_counts, io_counts,
                                         sharded_counts, x_counts,
                                         full_counts))
        r = results[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "checked_against_plain": True,
            **{k: v for k, v in r.items()
               if k in ("shape", "wave", "int32_bound_ms",
                        "k2_wave_bound_ms", "k2_ms", "k1_wave_bound_ms",
                        "k1_ms")
               or k.startswith("stacked_")},
        })
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(card_line, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]) if len(sys.argv) > 1 else main())
