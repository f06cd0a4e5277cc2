"""Propagation rounds a job's family clustering takes: the "rounds"
counter of the program's "families.propagate" spans, summed over the
measured window and divided by the jobs completed."""

from harness import program_trace


def read(run):
    return program_trace.counter(run, "families.propagate", "rounds")
