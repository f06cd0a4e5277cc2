"""Host seconds a job spends in the program's "io.scan_names" span (the
record-name scan of ``io/fasta.read_fasta`` after the native parse),
summed over the measured window's spans and divided by the jobs
completed."""

from harness import program_trace


def read(run):
    return program_trace.host_s(run, "io.scan_names")
