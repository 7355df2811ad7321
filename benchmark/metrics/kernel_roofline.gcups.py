"""The least time the card could take for the window's cell updates
(`benchmark.peaks.bound_seconds`) as a share of the device time of all
kernels in the traced window, in percent."""

from benchmark import peaks


def read(run):
    if run.trace is None:
        return None
    return peaks.roofline_pct(run.cells, run.db_bytes, run.trace.kernel_s)
