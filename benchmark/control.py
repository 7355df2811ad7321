"""The control of the comparison, on the card at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--cap 255]

For each seed it makes the cell's database and the queries of the calls
a run's check would keep (the first ``check.calls`` calls of the window's
stream), puts the reference computed with every ``H`` saturated at
``--cap`` (an unsigned 8-bit pass without Opal's escalation to wider
scores, which is also what the program's narrow q8 pass returns) in the
program's place, and prints the numbers the check compares, with the
exact reference's scores summarised beside them.  It reads only cells
that run ``sw`` in score mode, and refuses any other: the cap is a
control of the Smith-Waterman scores alone.  Benchmark runs never run
it.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from benchmark import check, generate, harness, reference  # noqa: E402


def control_reading(spec, seed, device, cap):
    traffic, scoring = spec.traffic, spec.config["scoring"]
    algorithm, mode = spec.judged()
    if (algorithm, mode) != ("sw", "score"):
        raise harness.Failure(
            2, f"{spec.cell['name']} runs {algorithm} in {mode} mode: "
            "the cap control reads sw score-mode cells only"
        )
    data = harness.Data(spec.config, seed, device)
    stream = data.queries(traffic, seed, generate.STREAM_WINDOW)
    kept = [(stream.call(k), None) for k in range(int(traffic["check"]["calls"]))]
    top = []

    def lower(call, targets):
        got = reference.sw_scores(
            call.codes, data.codes, data.offsets, data.lengths, targets,
            scoring["table"], scoring["gap_open"], scoring["gap_extend"],
            device=device, cap=cap,
        )
        top.append(int(got.max()))
        return got

    t = time.perf_counter()
    verdict = check.compare(
        kept, data, scoring, traffic["check"]["targets"], seed, device, 0,
        program=lower,
    )
    return {
        "seed": seed,
        "numbers": verdict.numbers,
        "correct": verdict.correct,
        "answers": verdict.answers_checked,
        "seconds_both_references": time.perf_counter() - t,
        "control_max": max(top),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--cap", type=int, default=255)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 3
    try:
        spec = harness.Spec(Path(ROOT), args.workload)
        for seed in args.seeds:
            out = control_reading(spec, seed, torch.device("cuda"), args.cap)
            out["workload"] = args.workload
            print(json.dumps(out), flush=True)
    except harness.Failure as exc:
        print(f"no control: {exc}", file=sys.stderr, flush=True)
        return exc.code
    return 0


if __name__ == "__main__":
    sys.exit(main())
