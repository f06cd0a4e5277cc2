"""Seconds a job spends building the pairwise path's k-mer indexes: the
stages "revcomp", "index_x" and "index_y" of the program's own stage timer
(`device.compare(timings=)`, each stage ended by a device
synchronisation), summed over the window's jobs and divided by the jobs
completed; pairwise jobs of the single-device pipeline only."""

STAGES = ("revcomp", "index_x", "index_y")


def read(run):
    walls = [run.stages[s] for s in STAGES if s in run.stages]
    return run.per_job(sum(walls)) if walls else None
