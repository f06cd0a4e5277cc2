"""Host seconds a job spends writing its outputs (the CSV, the family
summary, the BED and, when masking, the masked FASTA), summed over the
window's jobs and divided by the jobs completed."""


def read(run):
    return run.per_job(run.spans.get("write"))
