"""Seconds a job spends in the single-device pipeline's "seeds" stage, from
the program's own stage timer (`device.compare(timings=)`, each stage
ended by a device synchronisation), summed over the window's jobs and
divided by the jobs completed."""


def read(run):
    if run.backend != "device":
        return None
    return run.per_job(run.stages.get("seeds"))
