"""Readers of the program's own trace (``repkiller_tpu_torch.utils.trace``):
a named span's host seconds or device seconds, or a counter of it, summed
over the spans of the measured window and divided by the jobs completed.

The window runs from the first measured job's start to the last one's
end, on the ``time.perf_counter()`` clock that both the harness's job
records and the program's spans use; the warm-up job, the reference and
the profiled jobs lie outside it. A reader gives ``None`` where the
program records no such span (a program without the trace, or a cell
whose path has no such layer), where a span of the window has no device
time yet, or where the window lost spans to the trace's ring.
"""

from __future__ import annotations

import importlib
from typing import List, Optional


def window_spans(run) -> Optional[List[dict]]:
    """The program's finished spans inside the measured window, or None."""
    try:
        trace = importlib.import_module("repkiller_tpu_torch.utils.trace")
    except ImportError:
        return None
    if not run.jobs:
        return None
    lo, hi = run.jobs[0].start, run.jobs[-1].end
    spans = trace.spans()
    if trace.dropped() and (not spans or spans[0]["t1"] > lo):
        return None                          # the ring pushed some out
    return [s for s in spans if lo <= s["t0"] and s["t1"] <= hi]


def _per_job(run, values) -> Optional[float]:
    return run.per_job(sum(values)) if values else None


def host_s(run, *names: str) -> Optional[float]:
    """Host seconds of the spans named ``names``, per job."""
    spans = window_spans(run)
    if spans is None:
        return None
    return _per_job(run, [s["t1"] - s["t0"] for s in spans
                          if s["name"] in names])


def device_s(run, *names: str) -> Optional[float]:
    """Device seconds (CUDA events) of the spans named ``names``, per job."""
    spans = window_spans(run)
    if spans is None:
        return None
    times = [s["device_s"] for s in spans if s["name"] in names]
    if any(t is None for t in times):
        return None
    return _per_job(run, times)


def counter(run, name: str, key: str) -> Optional[float]:
    """Counter ``key`` of the spans named ``name``, per job."""
    spans = window_spans(run)
    if spans is None:
        return None
    return _per_job(run, [s["counters"][key] for s in spans
                          if s["name"] == name and key in s["counters"]])
