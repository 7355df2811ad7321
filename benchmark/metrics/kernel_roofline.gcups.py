"""The least time one card could take for the window's cell updates
(`benchmark.peaks.bound_seconds`) as a share of the device time of all
kernels in the traced window, summed over the cards, in percent: the
same work reads the same whatever the number of cards that did it."""

from benchmark import peaks


def read(run):
    if run.trace is None:
        return None
    return peaks.roofline_pct(run.cells, run.db_bytes, run.trace.kernel_s)
