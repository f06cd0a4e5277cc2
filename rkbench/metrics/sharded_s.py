"""Seconds a job spends in the sharded comparison less its family
clustering: the span around ``api.compare(backend="sharded")`` minus the
families span, summed over the window's jobs and divided by the jobs
completed."""


def read(run):
    if run.backend != "sharded" or "compare" not in run.spans:
        return None
    return run.per_job(run.spans["compare"] - run.spans.get("families", 0.0))
