"""Host seconds a job spends clustering families: a span around the
program's ``cluster_families``, wrapped at run time where the pipelines
call it, summed over the window's jobs and divided by the jobs
completed."""


def read(run):
    return run.per_job(run.spans.get("families"))
