"""Host seconds a job spends in the program's "report.bed" span (the BED
writer of repeat intervals, ``report/intervals.write_intervals_bed``),
summed over the measured window's spans and divided by the jobs
completed."""

from harness import program_trace


def read(run):
    return program_trace.host_s(run, "report.bed")
