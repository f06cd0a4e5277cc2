"""Kernel K2 (ungapped x-drop) against its roofline, in %: the least time
the traced jobs' ungapped extensions need on this card (harness roofline:
steps the reference counts x 12 int32 ops, or the bytes, whichever
bounds) over the device time of the kernels whose names contain
"xdrop"."""


def read(run):
    if run.trace is None or run.mode != "ungapped" or not run.least_s:
        return None
    t = run.trace.device_s("xdrop")
    return 100.0 * run.least_s / t if t > 0 else None
