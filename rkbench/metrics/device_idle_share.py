"""The share of the traced jobs' wall, in %, in which nothing ran on the
device: 100 x (1 - the union of device operation intervals / the span of
the profiled whole jobs, reading, clustering and writing included). The
profiler slows the host, so this is an upper bound."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
