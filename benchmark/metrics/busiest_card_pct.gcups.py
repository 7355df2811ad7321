"""The busiest card's share of the kernel time of all the cell's cards
in the traced window, in percent: 100 / cards where the work is even,
100 where one card does it all."""


def read(run):
    if run.trace is None or not sum(run.trace.card_kernel_s):
        return None
    return 100.0 * max(run.trace.card_kernel_s) / sum(run.trace.card_kernel_s)
