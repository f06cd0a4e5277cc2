"""Device seconds a job spends in the sharded path's merge (stage C) and
its copy-out (counter gather, capacity checks, the table to the host):
CUDA-event time of the program's "sharded.merge" and "sharded.copy_out"
spans, summed over the measured window and divided by the jobs
completed."""

from harness import program_trace


def read(run):
    return program_trace.device_s(run, "sharded.merge", "sharded.copy_out")
