"""Median latency of the window's calls, each from the call to its
return on the host's clock, in milliseconds."""

from benchmark import peaks


def read(run):
    return peaks.percentile([(b - a) * 1e3 for a, b, _, _ in run.calls], 50)
