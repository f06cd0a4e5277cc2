"""Device seconds a job spends in the sharded path's regroup (pack and
all-to-all) and per-window thinning and extension (stage B): CUDA-event
time of the program's "sharded.regroup" and "sharded.extend" spans,
summed over the measured window and divided by the jobs completed."""

from harness import program_trace


def read(run):
    return program_trace.device_s(run, "sharded.regroup", "sharded.extend")
