"""Host seconds a job spends in the program's "families" span (family
clustering, ``families/cluster.cluster_families``), summed over the
measured window's spans and divided by the jobs completed; unlike
``families_s`` it does not count the warm-up job."""

from harness import program_trace


def read(run):
    return program_trace.host_s(run, "families")
