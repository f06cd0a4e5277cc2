"""Seconds from the start of the process to the first timed job: imports,
CUDA initialisation, kernel libraries, the pool genomes and their FASTA
files, and the warm-up job."""


def read(run):
    return run.setup_s
