"""Device seconds a job spends enumerating the sharded path's seed hits:
CUDA-event time of the program's "sharded.hits" spans (the self path's
canonical-index enumeration; a pair's join of each query window against
Y's index, per strand), summed over the measured window and divided by
the jobs completed."""

from harness import program_trace


def read(run):
    return program_trace.device_s(run, "sharded.hits")
