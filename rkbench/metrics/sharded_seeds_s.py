"""Device seconds a job spends in the sharded path's index build and
hit enumeration (stage A): CUDA-event time of the program's
"sharded.index" and "sharded.hits" spans, summed over the measured
window and divided by the jobs completed."""

from harness import program_trace


def read(run):
    return program_trace.device_s(run, "sharded.index", "sharded.hits")
