"""Device seconds a job spends in the sharded self path's regroup: each
body's hits packed by destination window and the all-to-all along the
data axis that sends them there. CUDA-event time of the program's
"sharded.regroup" span, summed over the measured window and divided by
the jobs completed."""

from harness import program_trace


def read(run):
    return program_trace.device_s(run, "sharded.regroup")
