"""Time full mode's kernels T1 and T2 per batch of one 256-aa query.

Usage (on a machine with a CUDA card)::

    python3 tools/traceback_timing.py [TREE ...]

For each TREE (a checkout of this repository; default: the one holding
this script), imports that tree's ``pyopal_tpu_torch``, builds its
kernels, and times ``ops.traceback._dir_matrix_batch`` (T1) and
``_walk_batch_device`` (T2) on every batch of one ``align(mode="full")``
query over ``chip_smoke.py``'s main database (256 residues, sw, BLOSUM50,
gaps 3/1; ends from the score pass), each launch as the device time of
three launches queued behind a sleep on the card, so that the host's time
to issue them stays out.  Prints one JSON line per tree: the per-batch
times and their sums, with the card's name and power limit.  Trees are
timed one after the other in one process, so that two versions compare
on one card: run ``parent final final parent``.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def _import_tree(tree):
    """The tree's ``pyopal_tpu_torch``, imported afresh."""
    for name in list(sys.modules):
        if name.split(".")[0] == "pyopal_tpu_torch":
            del sys.modules[name]
    sys.path.insert(0, tree)
    try:
        pt = importlib.import_module("pyopal_tpu_torch")
        importlib.import_module("pyopal_tpu_torch.ops.engine")
        importlib.import_module("pyopal_tpu_torch.ops.traceback")
    finally:
        sys.path.remove(tree)
    return pt


def time_tree(tree, workload):
    import torch

    pt = _import_tree(tree)
    engine = pt.ops.engine
    tb = pt.ops.traceback
    dev = torch.device("cuda")
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0])

    def queued(fn, args, n=3, hold_ms=5.0):
        fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_ms * 1e-3 * clock_mhz * 1e6))
        start.record()
        for _ in range(n):
            fn(*args)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / n

    db_seqs, queries = workload
    db = pt.Database(db_seqs)
    targets = [db.get_encoded(i) for i in range(len(db))]
    q = np.frombuffer(db.alphabet.encode(queries[0]), np.uint8)
    S = pt.ScoringMatrix.from_name("BLOSUM50").int_data()
    with db.lock.read:
        _, qe, te = engine.search_scores(db, 0, len(db), q, S, 3, 1, "sw",
                                         device=dev)
    prof = torch.from_numpy(np.ascontiguousarray(
        S[q.astype(np.int64)])).to(dev)
    batches, _ = tb.plan_batches(len(q), [len(t) for t in targets])
    t1, t2 = [], []
    for batch in batches:
        tgt, tlen = tb.pad_batch(targets, batch)
        qes, tes = tb.walk_ends(targets, batch, tgt.shape[0], len(q), qe, te,
                                "sw")
        a1 = (prof, torch.from_numpy(tgt).to(dev), 3, 1, "sw",
              torch.from_numpy(tlen).to(dev))
        t1.append(queued(tb._dir_matrix_batch, a1))
        a2 = (tb._dir_matrix_batch(*a1), torch.from_numpy(qes).to(dev),
              torch.from_numpy(tes).to(dev), "sw")
        t2.append(queued(tb._walk_batch_device, a2))
    return {"tree": tree, "t1_query_ms": sum(t1), "t2_query_ms": sum(t2),
            "t1_longest_batch_ms": t1[-1], "t2_longest_batch_ms": t2[-1],
            "t1_per_batch_ms": t1, "t2_per_batch_ms": t2,
            "batches": len(batches), "card": _card()}


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("traceback_timing: CUDA is not available", file=sys.stderr)
        return 1
    trees = [os.path.abspath(t) for t in argv] or [HERE]
    sys.path.insert(0, HERE)
    import chip_smoke

    workload = chip_smoke.main_workload()
    sys.path.remove(HERE)
    for tree in trees:
        print(json.dumps(time_tree(tree, workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
