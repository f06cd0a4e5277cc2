"""Host seconds a job spends in the program's "report.summary" span (the
family summary writer, ``report/intervals.write_family_summary``), summed
over the measured window's spans and divided by the jobs completed."""

from harness import program_trace


def read(run):
    return program_trace.host_s(run, "report.summary")
