"""95th percentile of the latency of all the window's calls, in
milliseconds."""

from benchmark import peaks


def read(run):
    return peaks.percentile([(b - a) * 1e3 for a, b, _, _ in run.calls], 95)
