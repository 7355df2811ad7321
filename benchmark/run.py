"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``; ``check``, the
numbers compared and their limits, comes last); the last lines of
standard error repeat the numbers compared.  A run that cannot give a
result (no card, too few cards, no package, a JAX module loaded) prints
why on standard error and exits with a code other than 0.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root, not this directory, heads the import path
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402


def _caches_in_checkout():
    """Keep every compiler cache a run could fill inside the checkout, at
    fixed paths, so that only a checkout's first run builds."""
    base = Path(ROOT) / "build" / "benchmark_cache"
    for var, sub in (
        ("TRITON_CACHE_DIR", "triton"),
        ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
        ("CUDA_CACHE_PATH", "nv"),
    ):
        os.environ[var] = str(base / sub)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches_in_checkout()
    from benchmark import harness

    try:
        result = harness.run_cell(
            Path(ROOT), args.workload, args.seed, args.seconds, bool(args.trace),
            t_process=T_PROCESS,
        )
    except harness.Failure as exc:
        print(f"no result: {exc}", file=sys.stderr, flush=True)
        return exc.code
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
