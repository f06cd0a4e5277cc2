"""Reduction of a ``torch.profiler`` trace of whole jobs: when the device
was busy, what ran on it, and what the host was doing while it idled.

Device time is the union of the intervals of every kernel, copy and set
on the device, so overlapping work counts once. The window is the span
of the profiled jobs on the host, from the first one's start to the last
one's end, so an idle share over it covers reading, clustering and
writing too. The profiler slows the host, so that share is an upper
bound.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SPAN = "rkbench."


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Disjoint, sorted union of (start, end) intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def gaps(busy, lo: float, hi: float):
    """Idle intervals of [lo, hi] between the disjoint sorted ``busy``."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def label_of(t: float, spans: List[Tuple[float, float, str]]) -> str:
    """The innermost host span open at ``t``, or "other"."""
    best, width = "other", float("inf")
    for s, e, name in spans:
        if s <= t <= e and e - s < width:
            best, width = name, e - s
    return best


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: Dict[str, float] = field(default_factory=dict)   # by name
    idle_by_span: Dict[str, float] = field(default_factory=dict)

    def device_s(self, pattern: str) -> float:
        """Device seconds of the kernels whose names contain ``pattern``."""
        return sum(s for n, s in self.kernel_s.items() if pattern in n)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}


def reduce(device_events, host_spans, jobs) -> Trace:
    """``device_events``: (name, start_us, end_us) of every operation on
    the device; ``host_spans``: (name, start_us, end_us) of the
    benchmark's spans; ``jobs``: (start_us, end_us) of each profiled job,
    all on the profiler's clock."""
    lo = min(s for s, _ in jobs)
    hi = max(e for _, e in jobs)
    by_name = defaultdict(float)
    ivs = []
    for name, s, e in device_events:
        by_name[name] += (e - s) * 1e-6
        ivs.append((s, e))
    busy = clip(union(ivs), lo, hi)
    spans = [(s, e, n[len(SPAN):] if n.startswith(SPAN) else n)
             for n, s, e in host_spans if n != SPAN + "job"]
    idle = defaultdict(float)
    edges = sorted({t for s, e, _ in spans for t in (s, e)})
    for s, e in gaps(busy, lo, hi):
        # a gap that crosses span boundaries is split at them
        cuts = [s] + [t for t in edges if s < t < e] + [e]
        for a, b in zip(cuts[:-1], cuts[1:]):
            idle[label_of((a + b) / 2, spans)] += (b - a) * 1e-6
    return Trace(window_s=(hi - lo) * 1e-6,
                 busy_s=sum(e - s for s, e in busy) * 1e-6,
                 kernel_s=dict(by_name), idle_by_span=dict(idle))


def from_profiler(prof) -> Trace:
    """Trace of a finished ``torch.profiler.profile`` whose jobs ran inside
    ``rkbench.job`` ranges."""
    dev, host, jobs = [], [], []
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        if str(ev.device_type).endswith("CUDA"):
            # a host range the profiler mirrors on the device's timeline
            # is no device work
            if not (getattr(ev, "is_user_annotation", False)
                    or ev.name.startswith(SPAN)):
                dev.append((ev.name, s, e))
        elif ev.name.startswith(SPAN):
            host.append((ev.name, s, e))
            if ev.name == SPAN + "job":
                jobs.append((s, e))
    if not jobs:
        raise RuntimeError("the profiler recorded no job")
    return reduce(dev, host, jobs)
