"""Host seconds a job spends in the program's "families.propagate" span
(min-label propagation of family clustering, on the host or the device),
summed over the measured window's spans and divided by the jobs
completed."""

from harness import program_trace


def read(run):
    return program_trace.host_s(run, "families.propagate")
