"""Host seconds a job spends in the program's "report.masked_fasta" span
(``api.Result.masked_fasta``: the intervals, the masking and the text),
summed over the measured window's spans and divided by the jobs
completed; masking cells only."""

from harness import program_trace


def read(run):
    return program_trace.host_s(run, "report.masked_fasta")
