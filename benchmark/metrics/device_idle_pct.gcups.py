"""Share of the traced window in which no kernel and no copy ran, card
by card, in percent: 100 x (1 - the cards' summed busy time / (cards x
window)); a card that ran nothing is idle all through."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
