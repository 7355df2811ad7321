"""A cell defined only by fixture files: a checkout root holding its own
``BENCHMARK.json`` and configuration, and a data directory holding its
traffic and the metric readers, at a size the CPU runs in seconds."""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

from benchmark import generate

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"

#: a nucleotide configuration's scoring: 4 letters, a match/mismatch
#: table and no matrix of the package by name
DNA_SCORING = {
    "algorithm": "hw",
    "matrix": None,
    "gap_open": 6,
    "gap_extend": 2,
    "letters": "ACGT",
    "table": [[2 if i == j else -4 for j in range(4)] for i in range(4)],
}


def tiny_database(count=120, median=60, clip=(30, 160), seed=3):
    db = {
        "count": count,
        "residues": 0,
        "lengths": {
            "kind": "lognormal_draw", "seed": seed, "median": median,
            "sigma": 0.45, "clip": list(clip),
        },
    }
    spec = db["lengths"]
    import numpy as np

    rng = np.random.default_rng(spec["seed"])
    lengths = np.clip(
        rng.lognormal(np.log(median), 0.45, count).astype(int), *clip
    )
    db["residues"] = int(lengths.sum())
    generate.database_lengths(db)  # the fixture states its own sums
    return db


def make_cell(tmp: Path, *, config="sprot12071-blosum50", api="align_arrays",
              per_call=8, lengths=(40,), one_query=False, check=None,
              database=None, name="fixture.cell", chips=1, mesh=None,
              scoring=None, options=None):
    """Write the fixture files; returns ``(root, data_dir, name)``.

    ``scoring`` replaces the configuration's scoring (`DNA_SCORING`),
    ``options`` the traffic's (sw in score mode)."""
    root = Path(tmp) / "checkout"
    data = Path(tmp) / "data"
    (root / "cfg").mkdir(parents=True, exist_ok=True)
    (data / "traffic").mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", data / "metrics", dirs_exist_ok=True)
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    cfg["database"] = database or tiny_database()
    if scoring is not None:
        cfg["scoring"] = scoring
    (root / "cfg" / "tiny.json").write_text(json.dumps(cfg))
    traffic = {
        "api": api,
        "options": options or {"mode": "score", "algorithm": "sw"},
        "queries_per_call": per_call,
        "lengths": {"values": list(lengths)},
        "residues": {"from": "database_window", "substitution": 0.3},
        "check": check or {"calls": 2, "targets": "all"},
    }
    if one_query:
        traffic["one_query"] = True
    if mesh:
        traffic["mesh"] = mesh
    (data / "traffic" / "fixture_mix.json").write_text(json.dumps(traffic))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [
        {"name": "tiny", "source": "fixture", "file": "cfg/tiny.json",
         "reduced": [], "why": "fixture"}
    ]
    bench["workloads"] = [
        {"name": name, "config": "tiny", "traffic": "fixture_mix",
         "chips": chips, "why": "fixture"}
    ]
    latency = {"query_p50_ms", "query_p95_ms"}
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = [name] if (m["name"] in latency) == one_query else []
    for m in bench["per_layer"]:
        if "workloads" in m:
            reads_latency = m["moves"] in latency
            m["workloads"] = [name] if reads_latency == one_query else []
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    os.symlink(REPO / "pyopal_tpu_torch", root / "pyopal_tpu_torch")
    return root, data, name


def run(tmp, monkeypatch, seconds=0.3, traced=False, seed=2**31 + 11, **kw):
    """Run the fixture cell on the CPU; returns the result line's object."""
    from benchmark import harness

    monkeypatch.setattr(harness, "PREPARED_CALLS", 16)
    root, data, name = make_cell(tmp, **kw)
    return harness.run_cell(
        root, name, seed, seconds, traced, device="cpu",
        require_cuda=False, data_dir=data,
    )
