"""A cell run as n ranks, one process and one card each, as ``cli run
--num-processes n --process-id i --coordinator host:port`` runs the
sharded backend.

Rank 0 is the measuring process (``run.py``). It starts ranks 1..n-1 as
processes of ``rank.py`` on cards 1..n-1, and every rank joins the
program's process group (``dist.mesh.init_distributed``, NCCL on CUDA and
gloo on the CPU) through a free port on 127.0.0.1. A second group, gloo
over the same ranks, carries the harness's control messages on the host,
so that no control traffic lands on the cards:

- ``job``: every rank runs the same job of :class:`job.Job` (read, compare
  over the (data, shard) ``ProcessMesh``, cluster, and the writers, which
  ``write_on_host0`` leaves to rank 0), then all ranks gather whether it
  succeeded; a job that failed on any rank is a failed job on rank 0.
- ``peak``: every rank's ``max_memory_allocated``; rank 0 keeps the
  largest, the fullest card's.
- ``profile``: the helpers' profiled jobs under ``torch.profiler`` start
  or end; at the end each reduces its trace and sends its device busy
  seconds and window.
- ``stop``: every rank leaves the groups and the helpers exit.

No run hangs. Rank 0 watches the helpers from a thread: a helper that
exits before ``stop``, a control message that waits more than
``CONTROL_TIMEOUT_S``, or a phase that overruns its limit ends the run at
once: the helpers are killed and waited for, the work directory is
removed, and rank 0 exits with ``FATAL_EXIT`` and prints no result. A
helper dies with rank 0 (``PR_SET_PDEATHSIG``), so none outlives the run.
"""

from __future__ import annotations

import contextlib
import ctypes
import datetime
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

HELPER = Path(__file__).resolve().parent.parent / "rank.py"
CONTROL_TIMEOUT_S = 90      # a control message waited for longer: the
                            # group stopped answering
JOIN_LIMIT_S = 300          # helpers started, imported and joined
WARM_LIMIT_S = 900          # the first job, which builds the kernels
JOB_LIMIT_S = 120           # any later job
STOP_LIMIT_S = 60           # helpers leave the groups and exit
FATAL_EXIT = 4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def die_with_parent(parent: int) -> None:
    """In a helper, first thing: SIGKILL when rank 0 ends (Linux's
    PR_SET_PDEATHSIG), and exit now if it already has."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(FATAL_EXIT)


def _join(coordinator: str, world: int, rank: int, device_type: str):
    """Join the program's process group and make the control group."""
    from repkiller_tpu_torch.dist.mesh import init_distributed
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")   # all ranks on one host
    init_distributed(coordinator, world, rank, device=device_type)
    return dist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=CONTROL_TIMEOUT_S))


def _peak(device: str) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


class Ranks:
    """Rank 0's side: the helper processes, their watch, the control
    group. Make it before the pool (the helpers import and reach their
    cards meanwhile), then :meth:`join`; :meth:`close` always."""

    def __init__(self, n: int, device: str, log=print,
                 cleanup: Callable[[], None] = lambda: None):
        self.n = n
        self.device = device
        self.device_type = torch.device(device).type
        self.log = log
        self.cleanup = cleanup
        self.control = None
        self.coordinator = f"127.0.0.1:{free_port()}"
        self.procs: List[subprocess.Popen] = []
        self._phase: Optional[tuple] = None      # (name, deadline)
        self._stopping = False
        self._done = threading.Event()
        self._ending = threading.Lock()
        for r in range(1, n):
            self.procs.append(subprocess.Popen(
                [sys.executable, str(HELPER), "--rank", str(r), "--world",
                 str(n), "--coordinator", self.coordinator, "--device",
                 self.device_type, "--parent", str(os.getpid())],
                stdin=subprocess.DEVNULL, stdout=sys.stderr.fileno()))
        self._watch = threading.Thread(target=self._watching, daemon=True)
        self._watch.start()

    # ------------------------------------------------------------ watch

    def _watching(self) -> None:
        while not self._done.wait(0.25):
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc is not None and not self._stopping:
                    self._fatal(f"helper rank {r} exited with {rc}")
            phase = self._phase
            if phase is not None and time.monotonic() > phase[1]:
                self._fatal(f"{phase[0]} overran its limit: the group "
                            "stopped answering")

    def _fatal(self, why: str) -> None:
        """End the run now, from any thread: no result, no process left."""
        if not self._ending.acquire(blocking=False):
            threading.Event().wait()           # another thread is ending it
        self.log(f"# ranks: {why}; the run ends without a result")
        self._kill()
        try:
            self.cleanup()
        finally:
            sys.stderr.flush()
            os._exit(FATAL_EXIT)

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def phase(self, name: Optional[str], limit: float = 0.0) -> None:
        """The phase rank 0 enters and the seconds it may take (None: no
        limit)."""
        self._phase = (None if name is None
                       else (name, time.monotonic() + limit))

    # ---------------------------------------------------------- control

    def send(self, msg: dict) -> None:
        box = [msg]
        try:
            dist.broadcast_object_list(box, src=0, group=self.control)
        except RuntimeError as e:
            self._fatal(f"control message {msg['op']!r} failed: {e}")

    def gather(self, value) -> list:
        out = [None] * self.n
        try:
            dist.all_gather_object(out, value, group=self.control)
        except RuntimeError as e:
            self._fatal(f"control gather failed: {e}")
        return out

    def join(self, config: dict, settings: dict) -> None:
        """Join the groups and hand the helpers the cell's configuration."""
        self.phase("joining the process group", JOIN_LIMIT_S)
        self.control = _join(self.coordinator, self.n, 0, self.device_type)
        self.send({"op": "cell", "config": config, "settings": settings})
        self.phase(None)

    def peak(self) -> int:
        """The largest ``max_memory_allocated`` of any rank's card."""
        self.send({"op": "peak"})
        each = self.gather(_peak(self.device))
        self.log("# peak memory by rank (GiB): "
                 + " ".join(f"{b / 2**30:.4f}" for b in each))
        return max(each)

    def profile(self, on: bool) -> None:
        """Start or stop the helpers' profiler; once stopped, each reduces
        its trace while rank 0 reduces its own."""
        self.send({"op": "profile", "on": on})

    def profiled(self) -> list:
        """Each helper's (busy_s, window_s) of its profiled jobs."""
        return self.gather(None)[1:]

    def close(self) -> None:
        """Stop the helpers and leave the groups; kill what does not exit
        within STOP_LIMIT_S."""
        try:
            if self.control is not None:
                self.phase("stopping", STOP_LIMIT_S)
                self._stopping = True
                self.send({"op": "stop"})
                dist.destroy_process_group()
                self.control = None
                for p in self.procs:
                    try:
                        p.wait(timeout=STOP_LIMIT_S)
                    except subprocess.TimeoutExpired:
                        self.log("# ranks: a helper did not exit; killed")
                        break
        finally:
            self._stopping = True
            self._done.set()
            self._kill()
            self.phase(None)


class RankedJob:
    """A :class:`job.Job` run on every rank at once; the same ``run``."""

    def __init__(self, ranks: Ranks, job):
        self.ranks = ranks
        self.job = job
        self.jobs = 0

    def run(self, path: str, prefix: str, spans, stages=None,
            path_y: Optional[str] = None):
        r = self.ranks
        first = self.jobs == 0
        self.jobs += 1
        r.send({"op": "job", "path": path, "prefix": prefix,
                 "path_y": path_y, "reset_peak": first})
        r.phase("the first job" if first else "a job",
                WARM_LIMIT_S if first else JOB_LIMIT_S)
        err = None
        try:
            frag = self.job.run(path, prefix, spans, stages, path_y)
        except Exception:                   # counted with the helpers'
            err = traceback.format_exc()
            frag = None
        errors = [e for e in r.gather(err) if e is not None]
        r.phase(None)
        if errors:
            raise RuntimeError("a rank failed its job:\n" + "\n".join(errors))
        return frag


def helper_main(argv=None) -> int:
    """Ranks 1..n-1: join, then follow rank 0's control messages."""
    import argparse

    from harness import profile as rk_profile
    from harness.job import Job, Spans

    ap = argparse.ArgumentParser(description="a helper rank of a cell run")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--parent", type=int, required=True)
    args = ap.parse_args(argv)
    die_with_parent(args.parent)
    device = f"cuda:{args.rank}" if args.device == "cuda" else args.device
    control = _join(args.coordinator, args.world, args.rank, args.device)

    def recv() -> dict:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=control)
        return box[0]

    def gather(value) -> None:
        dist.all_gather_object([None] * args.world, value, group=control)

    cell = recv()
    job = Job(cell["config"], cell["settings"], device)
    prof = None
    while True:
        msg = recv()
        if msg["op"] == "stop":
            break
        if msg["op"] == "peak":
            gather(_peak(device))
        elif msg["op"] == "profile":
            if msg["on"]:
                prof = _profiler(device)
                prof.start()
            else:
                prof.stop()
                tr = rk_profile.from_profiler(prof)
                gather((tr.busy_s, tr.window_s))
                prof = None
        elif msg["op"] == "job":
            err = None
            try:
                ctx = (torch.profiler.record_function(rk_profile.SPAN + "job")
                       if prof is not None else contextlib.nullcontext())
                with ctx:
                    job.run(msg["path"], msg["prefix"], Spans(False), None,
                            msg["path_y"])
            except Exception:
                err = f"rank {args.rank}:\n{traceback.format_exc()}"
            if msg["reset_peak"] and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            gather(err)
    dist.destroy_process_group()
    return 0


def _profiler(device: str):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)
