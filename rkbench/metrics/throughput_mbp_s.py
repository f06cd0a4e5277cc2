"""Input Mbp of every job completed in the window over the seconds from
the first job's start to the last job's end: all the work over all the
time."""


def read(run):
    done = run.done
    if not done:
        return None
    span = max(j.end for j in run.jobs) - min(j.start for j in run.jobs)
    return sum(j.bp for j in done) / 1e6 / span
