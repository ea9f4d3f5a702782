"""The share of the traced window in which no device operation ran: 1 -
the union of every kernel, copy and set's interval in the processes'
traces over the window's wall, less the profiler's own start and export
in each process, in %."""

from benchmark import devtrace


def read(view):
    if view.trace is None or not view.trace.device or view.traced_s <= 0:
        return None
    busy = devtrace.busy_seconds(view.trace.device)
    return 100.0 * (1.0 - busy / view.traced_s)
