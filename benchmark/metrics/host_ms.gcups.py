"""Host time a call: its wall time less the device's busy time inside
it, averaged over the traced window's calls, in milliseconds."""


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    host = [a - b for a, b in zip(run.trace.call_s, run.trace.call_busy_s)]
    return 1e3 * sum(host) / len(host)
