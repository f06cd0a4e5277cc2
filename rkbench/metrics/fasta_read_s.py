"""Host seconds a job spends reading its FASTA file (``read_fasta``),
summed over the window's jobs and divided by the jobs completed."""


def read(run):
    return run.per_job(run.spans.get("fasta_read"))
