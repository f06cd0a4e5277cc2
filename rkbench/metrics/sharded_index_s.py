"""Device seconds a job spends building the sharded path's k-mer
indexes: CUDA-event time of the program's "sharded.index" spans (the
self path's canonical index with revcomp(X); a pair's index of X, of Y
and of revcomp(Y)), summed over the measured window and divided by the
jobs completed."""

from harness import program_trace


def read(run):
    return program_trace.device_s(run, "sharded.index")
