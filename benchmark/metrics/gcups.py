"""Batch throughput: every cell update the window's calls needed (query
residues x database residues, unpadded), over the window's whole time
from its start to the last call's return."""

from benchmark import peaks


def read(run):
    return peaks.gcups(run.cells, run.window_s)
