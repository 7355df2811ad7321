"""One run of one cell: set-up, the measured window, the check, the
result line.

Everything that belongs to one configuration, traffic mix or metric is
a file found by its name: the configuration at the ``file`` that
``BENCHMARK.json`` gives it, the traffic at ``traffic/<name>.json`` and
each metric's reader at ``metrics/<name>.py`` under the data directory
(this package's directory).  A reader is a module with ``read(run)``
that returns a number, or None where it finds nothing to read.

The timed path is the public API of ``pyopal_tpu_torch``, called from a
client's side in a closed loop with one client: the traffic names the
`Aligner` method and its options, or a function of the package by its
dotted path (``"api": "parallel.align_arrays_sharded"``), which is given
the configuration's scoring as keywords and, where the traffic names a
mesh builder (``"mesh": "parallel.device_mesh"``), a mesh of the cell's
``chips`` built once in set-up.  Set-up makes the database and every
query from the seed, builds the `Database`, and warms up every call
shape of the traffic with queries of their own; the window then calls
the API until ``--seconds`` have passed, each call with queries no
earlier call had.

The configuration's ``scoring`` decides the program's matrix and
alphabet.  Where ``scoring.matrix`` names a matrix of the package
(``"BLOSUM62"``), the program gets that name and the `Database` the
package's default alphabet.  Where ``scoring.matrix`` is null or left
out, the program gets ``ScoringMatrix(scoring.table, scoring.letters)``
and the `Database` ``Alphabet(scoring.letters)``.  Residues are drawn
over ``scoring.letters`` either way.  The traffic's ``options.algorithm``
has to be ``scoring.algorithm``, and ``options.mode`` score or end:
set-up refuses any other cell (`check.judged`).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import check, generate, peaks, tracing

HERE = Path(__file__).resolve().parent
#: top-level modules that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "pyopal_tpu")
#: query residues and calls prepared in set-up, at most
PREPARED_RESIDUES = 32 << 20
PREPARED_CALLS = 8192


class Failure(Exception):
    """A run that cannot give a result; ``code`` is its exit code."""

    def __init__(self, code, message):
        super().__init__(message)
        self.code = code


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Spec:
    """A cell of ``BENCHMARK.json`` with its configuration and traffic."""

    def __init__(self, root: Path, workload: str, data_dir: Path = HERE):
        self.root = Path(root)
        self.data_dir = Path(data_dir)
        self.bench = load_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise Failure(2, f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.cell["config"]]
        self.config = load_json(self.root / self.config_entry["file"])
        self.traffic = load_json(
            self.data_dir / "traffic" / f"{self.cell['traffic']}.json"
        )

    def judged(self):
        """``(algorithm, mode)`` the check holds this cell to; a cell it
        cannot judge fails set-up (`check.judged`)."""
        try:
            return check.judged(self.traffic, self.config["scoring"])
        except ValueError as exc:
            raise Failure(2, f"{self.cell['name']}: {exc}") from None

    def _applies(self, metric, reported):
        listed = metric.get("workloads")
        if listed is not None:
            return self.cell["name"] in listed
        return reported is None or metric.get("moves") in reported

    def metrics(self, traced: bool):
        e2e = [m for m in self.bench["end_to_end"] if self._applies(m, None)]
        if not traced:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"] if self._applies(m, names)]

    def reader(self, name: str):
        path = self.data_dir / "metrics" / f"{name}.py"
        mod_name = "benchmark_metric_" + "".join(
            c if c.isalnum() else "_" for c in name
        )
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Data:
    """The generated database: codes, lengths and offsets per target,
    over the configuration's letters."""

    def __init__(self, config, seed, device):
        self.letters = config["scoring"]["letters"]
        self.lengths = generate.database_lengths(config["database"])
        self.offsets = generate.offsets_of(self.lengths)
        self.codes = generate.database_codes(
            int(self.lengths.sum()), seed, device, self.letters
        )

    def queries(self, traffic, seed, stream):
        """The traffic's `generate.QueryStream` ``stream`` on this
        database."""
        return generate.QueryStream(
            traffic, self.lengths, self.codes, seed, stream, self.letters
        )


class Run:
    """What the metric readers read: the window's calls on the host's
    clock, set-up time, and the traced window's summary."""

    def __init__(self):
        self.calls = []  # (start_s, end_s, cells, db_bytes)
        self.window_start = None
        self.setup_s = None
        self.trace = None

    @property
    def window_s(self):
        return self.calls[-1][1] - self.window_start

    @property
    def cells(self):
        return sum(c[2] for c in self.calls)

    @property
    def db_bytes(self):
        return sum(c[3] for c in self.calls)


def package_function(pt, dotted: str):
    """The function of the package ``pt`` at ``dotted``, a path below it
    (``"parallel.align_arrays_sharded"``)."""
    module, _, attr = dotted.rpartition(".")
    try:
        fn = getattr(importlib.import_module(f"{pt.__name__}.{module}"), attr)
    except (ImportError, AttributeError):
        fn = None
    if not callable(fn):
        raise Failure(2, f"{pt.__name__} has no function {dotted!r}")
    return fn


def program_scoring(pt, scoring):
    """``(matrix, alphabet)``: the matrix argument the program takes for
    the configuration's scoring, its name or a `ScoringMatrix` of its
    table, and the `Alphabet` of its `Database` (None: the default)."""
    if isinstance(scoring.get("matrix"), str):
        return scoring["matrix"], None
    return (
        pt.ScoringMatrix(scoring["table"], scoring["letters"]),
        pt.Alphabet(scoring["letters"]),
    )


def _call_fn(pt, db, traffic, scoring, matrix, dev, chips):
    """The timed call: an `Aligner` method with the configuration's
    scoring, or a function of the package given it as keywords, with a
    mesh of ``chips`` shards where the traffic names a mesh builder."""
    options = traffic.get("options", {})
    if "." in traffic["api"]:
        fn = package_function(pt, traffic["api"])
        options = dict(
            options, scoring_matrix=matrix,
            gap_open=scoring["gap_open"], gap_extend=scoring["gap_extend"],
        )
        if "mesh" in traffic:
            build = package_function(pt, traffic["mesh"])
            options["mesh"] = build(chips, device=dev.type)
    else:
        aligner = pt.Aligner(
            matrix, scoring["gap_open"], scoring["gap_extend"], device=dev,
        )
        fn = getattr(aligner, traffic["api"])
    if traffic.get("one_query"):
        return lambda call: fn(call.letters[0], db, **options)
    return lambda call: fn(call.letters, db, **options)


def _card():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return " | ".join(out.splitlines()) if out else "not read"


def forbidden_modules():
    return sorted(
        {m.split(".")[0] for m in sys.modules} & set(FORBIDDEN)
    )


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def run_cell(root, workload, seed, seconds, traced, *, t_process=None,
             device=None, require_cuda=True, data_dir=HERE):
    """Run one cell; returns the result line's object.  Raises `Failure`
    where the run gives no result."""
    t_entry = time.perf_counter()
    t_process = t_entry if t_process is None else t_process
    split = {"imports_s": t_entry - t_process}
    spec = Spec(root, workload, data_dir)
    chips = int(spec.cell["chips"])
    traffic, scoring = spec.traffic, spec.config["scoring"]
    _, mode = spec.judged()
    if require_cuda:
        if not torch.cuda.is_available():
            raise Failure(3, "torch sees no CUDA device")
        if torch.cuda.device_count() < chips:
            raise Failure(
                3, f"the cell needs {chips} cards, torch sees "
                f"{torch.cuda.device_count()}"
            )
    dev = torch.device(device or "cuda")
    if not (Path(root) / "pyopal_tpu_torch").is_dir():
        raise Failure(4, "no pyopal_tpu_torch package in the checkout")
    if str(Path(root).resolve()) not in sys.path:
        sys.path.insert(0, str(Path(root).resolve()))
    t = time.perf_counter()
    import pyopal_tpu_torch as pt

    split["package_s"] = time.perf_counter() - t
    t = time.perf_counter()
    torch.zeros(1, device=dev)
    split["device_init_s"] = time.perf_counter() - t
    t = time.perf_counter()
    data = Data(spec.config, seed, dev)
    seqs = generate.ascii_sequences(data.codes, data.lengths, data.letters)
    split["generate_s"] = time.perf_counter() - t

    t = time.perf_counter()
    matrix, alphabet = program_scoring(pt, scoring)
    db = pt.Database(seqs, alphabet=alphabet)
    del seqs
    call_fn = _call_fn(pt, db, traffic, scoring, matrix, dev, chips)
    split["database_s"] = time.perf_counter() - t
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    warm = data.queries(traffic, seed, generate.STREAM_WARMUP)
    warm_s = []
    for k in range(warm.distinct_shapes()):
        call = warm.call(k)
        t = time.perf_counter()
        call_fn(call)
        sync()
        warm_s.append(time.perf_counter() - t)
    split["first_call_s"] = warm_s[0]
    split["warmup_rest_s"] = sum(warm_s[1:])

    # queries for as many calls as the card's ceiling could complete, up
    # to PREPARED_RESIDUES; later calls' queries are made in the window
    t = time.perf_counter()
    stream = data.queries(traffic, seed, generate.STREAM_WINDOW)
    probe = stream.call(0)
    least = peaks.bound_seconds(probe.cells, probe.db_bytes)
    per_call = max(1, sum(c.shape[0] for c in probe.codes))
    n_ready = min(
        math.ceil(seconds / least) + 2,
        PREPARED_RESIDUES // per_call + 1,
        PREPARED_CALLS,
    )
    ready = [probe] + [stream.call(k) for k in range(1, n_ready)]
    split["queries_s"] = time.perf_counter() - t
    expected = max(1, int(seconds / max(warm_s[-1], 1e-3)))
    keep = check.checked_calls(expected, int(traffic["check"]["calls"]), seed)

    run = Run()
    kept, last, failed = [], None, 0
    profiler = tracing.Profiler() if traced else None
    # set-up's objects leave the collector's generations, so that the
    # window's collections scan only what the calls make
    gc.collect()
    gc.freeze()
    with tracing.layer_spans(traced):
        if profiler is not None:
            profiler.__enter__()
        try:
            with tracing.span(traced, tracing.WINDOW):
                start = time.perf_counter()
                run.window_start = start
                run.setup_s = start - t_process
                deadline = start + seconds
                k = 0
                while True:
                    if k >= len(ready):
                        with tracing.span(traced, tracing.CLIENT):
                            ready.append(stream.call(k))
                    call = ready[k]
                    ready[k] = None
                    with tracing.span(traced, tracing.CALL):
                        t0 = time.perf_counter()
                        try:
                            result = call_fn(call)
                        except Exception as exc:  # counted, and judged
                            log(f"call {k} raised {exc!r}")
                            result = None
                            failed += 1
                        t1 = time.perf_counter()
                    run.calls.append((t0, t1, call.cells, call.db_bytes))
                    if k in keep:
                        kept.append((call, result))
                    with tracing.span(traced, tracing.CLIENT):
                        # the client drops the previous call's results
                        last = (call, result)
                    k += 1
                    if t1 >= deadline:
                        break
        finally:
            if profiler is not None:
                profiler.__exit__(None, None, None)
    if last[0].index not in keep:
        kept.append(last)
    if profiler is not None:
        t = time.perf_counter()
        run.trace = tracing.Summary(
            profiler.events(), tracing.span_names(), chips
        )
        del profiler
        split["trace_read_s"] = time.perf_counter() - t

    # the fullest of the cell's cards
    memory_peaks = (
        [torch.cuda.max_memory_allocated(i)
         for i in range(min(chips, torch.cuda.device_count()))]
        if dev.type == "cuda" else [0]
    )
    found = forbidden_modules()
    if found:
        raise Failure(5, "modules loaded in this process: " + ", ".join(found))
    card = _card() if dev.type == "cuda" else "cpu"

    del db, call_fn
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    verdict = check.compare(
        kept, data, scoring, traffic["check"]["targets"], seed, dev, failed,
        mode=mode,
    )
    check_s = time.perf_counter() - t

    metrics = {}
    for m in spec.metrics(traced):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    log("card", card)
    log("setup_split", json.dumps({k: round(v, 4) for k, v in split.items()}))
    ms = [(b - a) * 1e3 for a, b, _, _ in run.calls]
    log("call_ms", " ".join(
        f"p{q}={peaks.percentile(ms, q):.3f}" for q in (0, 5, 25, 50, 75, 95, 100)
    ))
    log(f"window calls {len(run.calls)} seconds {run.window_s:.4f} "
        f"checked calls {verdict.calls_checked} answers "
        f"{verdict.answers_checked} in {check_s:.2f} s")
    result = {
        "correct": verdict.correct,
        "attempted": len(run.calls),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (
                torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
            ),
            "count": chips,
            "memory_peak_bytes": int(max(memory_peaks)),
        },
        "card": card,
        "cards": {"memory_peak_bytes": memory_peaks},
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["cards"]["busy_s"] = run.trace.card_busy_s
        result["cards"]["kernel_s"] = run.trace.card_kernel_s
        result["breakdown"] = {
            "device_ops": tracing.top(run.trace.device_ops),
            "idle_gaps": tracing.top(run.trace.idle_gaps),
        }
    result["check"] = verdict.as_json()
    for line in verdict.lines():
        log(line)
    return result
