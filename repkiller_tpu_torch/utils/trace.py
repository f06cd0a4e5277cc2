"""In-memory spans and counters of the program's layers.

A span times one call of a layer on the host's ``time.perf_counter()``
clock: its name, start ``t0`` and end ``t1``, the id of the span it was
opened in (a thread-local stack), a job id (the id of the outermost span
of its call tree, or of the ``job()`` span above it), the
``torch.distributed`` rank when a process group is active, and its
counters::

    with trace.job() as job_id:          # one id for read, compare, write
        with trace.span("compare", device=dev):
            ...
            trace.count("hits", n)       # the innermost span and the totals

Finished spans go into a ring of ``RING`` entries; ``dropped()`` counts
those it has pushed out, so a reader can tell that a window lost spans.
``totals()`` holds every counter summed over the life of the process.

A span given a CUDA ``device`` also records a timing event at entry and
at exit on that device's stream current at entry; ``device_s``, the
stream's time between the two, is read once both events are complete, when the outermost span
closes or when ``spans()`` is read. Nothing here waits for the device or
copies from it: a span whose events are not complete yet has
``device_s`` None.

While a ``torch.profiler`` is active, each span is also a
``record_function`` range named ``repkiller.<name>``, so the layers stand
on the profiler's timeline beside the kernels.
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

RING = 1 << 16
PREFIX = "repkiller."


class _Record:
    __slots__ = ("id", "parent", "job", "name", "t0", "t1", "rank",
                 "counters", "dev", "events", "device_s")

    def as_dict(self) -> dict:
        return {"id": self.id, "parent": self.parent, "job": self.job,
                "name": self.name, "t0": self.t0, "t1": self.t1,
                "rank": self.rank, "counters": dict(self.counters or {}),
                "device_s": self.device_s}


def _timing_device(device) -> Optional[torch.device]:
    """The CUDA device, with its index, that a span times; None for any
    other device or without a usable GPU."""
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _Span:
    """One open span; the context manager that ``Recorder.span`` returns."""

    __slots__ = ("rec", "r", "dev", "stream", "prof")

    def __init__(self, rec: "Recorder", name: str, device, job: bool):
        r = _Record()
        r.id = next(rec._ids)
        r.name = name
        r.counters = None
        r.events = None
        r.device_s = None
        r.job = r.id if job else None
        self.rec, self.r = rec, r
        self.dev = _timing_device(device)
        self.prof = None

    def __enter__(self) -> int:
        r, stack = self.r, self.rec._stack()
        if stack:
            top = stack[-1]
            r.parent = top.id
            if r.job is None:
                r.job = top.job
        else:
            r.parent = None
            if r.job is None:
                r.job = r.id
        r.rank = (dist.get_rank()
                  if dist.is_available() and dist.is_initialized() else None)
        if torch._C._autograd._profiler_enabled():
            self.prof = torch.profiler.record_function(PREFIX + r.name)
            self.prof.__enter__()
        if self.dev is not None:
            ev = self.rec._event(self.dev)
            self.stream = self.rec._current_stream(self.dev)
            ev.record(self.stream)
            r.dev, r.events = self.dev, (ev, None)
        stack.append(r)
        r.t0 = time.perf_counter()
        return r.id

    def __exit__(self, *exc) -> None:
        r = self.r
        r.t1 = time.perf_counter()
        if r.events is not None:
            ev = self.rec._event(self.dev)
            ev.record(self.stream)
            r.events = (r.events[0], ev)
        if self.prof is not None:
            self.prof.__exit__(*exc)
        stack = self.rec._stack()
        stack.pop()
        self.rec._finish(r, root=not stack)


class Recorder:
    """Spans of the program, in a ring of ``capacity``, and counter totals."""

    def __init__(self, capacity: int = RING):
        self._ring = collections.deque(maxlen=capacity)
        self._dropped = 0
        self._totals: Dict[str, int] = collections.defaultdict(int)
        self._pending: List[_Record] = []        # device events unread
        self._free = collections.defaultdict(list)   # read events, by device
        self._streams = {}                 # torch.cuda.Stream by stream data
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _event(self, dev: torch.device) -> torch.cuda.Event:
        """A timing event of ``dev``: one already read, else a new one."""
        try:
            return self._free[dev].pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    def _current_stream(self, dev: torch.device) -> torch.cuda.Stream:
        """``torch.cuda.current_stream(dev)``, without building a new
        Stream object for a stream already seen."""
        data = torch._C._cuda_getCurrentStream(dev.index)
        stream = self._streams.get(data)
        if stream is None:
            stream = self._streams[data] = torch.cuda.current_stream(dev)
        return stream

    def span(self, name: str, device=None) -> _Span:
        """Context manager of a span named ``name``; it gives the span's
        id. ``device``: time the span on that CUDA device's current stream
        too (any other device: not)."""
        return _Span(self, name, device, job=False)

    def traced(self, name: str):
        """Decorator: every call of the function is a span ``name``."""
        def wrap(fn):
            @functools.wraps(fn)
            def call(*args, **kwargs):
                with self.span(name):
                    return fn(*args, **kwargs)
            return call
        return wrap

    def job(self) -> _Span:
        """A span named "job" whose id every span under it shares as its
        job id, so separate calls make one job."""
        return _Span(self, "job", None, job=True)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` of the innermost open span of this
        thread and to the process's total."""
        stack = self._stack()
        if stack:
            r = stack[-1]
            if r.counters is None:
                r.counters = {}
            r.counters[name] = r.counters.get(name, 0) + n
        with self._lock:
            self._totals[name] += n

    def totals(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._totals)

    def dropped(self) -> int:
        """Spans pushed out of the ring so far."""
        return self._dropped

    def spans(self) -> List[dict]:
        """The finished spans in the ring, oldest first, as dicts."""
        self._resolve()
        with self._lock:
            return [r.as_dict() for r in self._ring]

    def _finish(self, r: _Record, root: bool) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(r)
            if r.events is not None:
                self._pending.append(r)
        if root:
            self._resolve()

    def _resolve(self) -> None:
        """``device_s`` of every span whose two events are complete: its
        end event is, and so, on the same stream, its start event."""
        with self._lock:
            pending, self._pending = self._pending, []
        left = []
        for r in pending:
            a, b = r.events
            if b.query():
                r.device_s = a.elapsed_time(b) * 1e-3
                r.events = None
                self._free[r.dev] += (a, b)
            else:
                left.append(r)
        if left:
            with self._lock:
                self._pending = left + self._pending


RECORDER = Recorder()
span = RECORDER.span
traced = RECORDER.traced
job = RECORDER.job
count = RECORDER.count
totals = RECORDER.totals
spans = RECORDER.spans
dropped = RECORDER.dropped
