"""Host seconds a job spends in the program's "report.csv" span (the
fragment CSV writer, ``report/csv_writer.write_frags_csv``), summed over
the measured window's spans and divided by the jobs completed."""

from harness import program_trace


def read(run):
    return program_trace.host_s(run, "report.csv")
