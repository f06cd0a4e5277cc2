"""Kernel K1 (banded Gotoh x-drop) against its roofline, in %: the least
time the traced jobs' banded extensions need on this card (harness
roofline: rows the reference counts x W cells x 30 int32 ops, or the
bytes, whichever bounds) over the device time of the kernels whose names
contain "gotoh"."""


def read(run):
    if run.trace is None or run.mode != "banded" or not run.least_s:
        return None
    t = run.trace.device_s("gotoh")
    return 100.0 * run.least_s / t if t > 0 else None
