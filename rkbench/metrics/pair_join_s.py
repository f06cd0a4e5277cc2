"""Seconds a job spends joining the pairwise path's two k-mer indexes and
thinning the hits: the stages "join" and "filter" of the program's own
stage timer (`device.compare(timings=)`, each stage ended by a device
synchronisation), summed over the window's jobs and divided by the jobs
completed; pairwise jobs of the single-device pipeline only."""

STAGES = ("join", "filter")


def read(run):
    walls = [run.stages[s] for s in STAGES if s in run.stages]
    return run.per_job(sum(walls)) if walls else None
