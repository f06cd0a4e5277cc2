"""One genome job through the program, as a batch annotation pipeline runs
it: read the FASTA, compare, cluster families, write every output file.
The steps mirror the program's ``cli run``; each is a call into one of
the program's layers. This module and ``ranks`` (which joins the
program's process group) are the only ones of the benchmark that import
the program. Inside a process group, as on every rank of a cell on
several cards, the sharded mesh is the program's ``ProcessMesh`` and the
files are left to rank 0 (``write_on_host0``), as ``cli run
--num-processes`` leaves them.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Optional

import torch

from repkiller_tpu_torch import api, device as rk_device
from repkiller_tpu_torch.config import Config
from repkiller_tpu_torch.dist import sharded as rk_sharded
from repkiller_tpu_torch.dist.merge import write_on_host0
from repkiller_tpu_torch.dist.mesh import make_mesh, process_group_active
from repkiller_tpu_torch.io.fasta import read_fasta

SUFFIXES = ("frags.csv", "families.csv", "repeats.bed", "masked.fasta")


class Spans:
    """Host seconds per span name, summed over the jobs (``on`` false:
    nothing is recorded). Each span is also a ``torch.profiler`` range
    named ``rkbench.<name>``, so a trace can tell what the host was doing
    while the device idled."""

    def __init__(self, on: bool):
        self.on = on
        self.total = defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"rkbench.{name}"):
            try:
                yield
            finally:
                self.total[name] += time.perf_counter() - t0


def install_family_span(spans: Spans):
    """Wrap the name ``cluster_families`` that the single-device and the
    sharded pipelines call, so that each call is a "families" span ->
    a function that takes the wrapper out again."""
    orig = rk_device.cluster_families

    def traced(*args, **kwargs):
        with spans("families"):
            return orig(*args, **kwargs)

    rk_device.cluster_families = rk_sharded.cluster_families = traced

    def remove():
        rk_device.cluster_families = rk_sharded.cluster_families = orig
    return remove


class Job:
    """The program's side of a cell: its Config, backend and mesh."""

    def __init__(self, config: dict, settings: dict, device: str):
        self.cfg = Config(**settings)
        self.backend = config["backend"]
        self.mask = config["mask"]
        self.device = device
        self.mesh = None
        if self.backend == "sharded":
            shape = config["mesh"]["n_data"], config["mesh"]["n_shard"]
            if process_group_active():        # a ProcessMesh, a body a rank
                self.mesh = make_mesh(*shape,
                                      device=torch.device(device).type)
            else:
                self.mesh = make_mesh(*shape, devices=[device] * shape[0]
                                      * shape[1])

    def run(self, path: str, prefix: str, spans: Spans,
            stages: Optional[dict] = None, path_y: Optional[str] = None):
        """One job -> its fragment table. ``stages`` (a dict; device
        backend) gathers the pipeline's own stage walls. ``path_y``: the
        second genome of a pairwise job, compared with the first as
        ``cli run fasta_x fasta_y`` does."""
        with spans("fasta_read"):
            seqs = read_fasta(path)
        ys = None
        if path_y is not None:
            with spans("fasta_read"):
                ys = read_fasta(path_y)
        with spans("compare"):
            if stages is not None:
                frag = rk_device.compare(seqs.codes,
                                         None if ys is None else ys.codes,
                                         self.cfg, self.device,
                                         timings=stages)
                res = api.Result(frag=frag, cfg=self.cfg, x=seqs, y=ys)
            else:
                res = api.compare(seqs, ys, self.cfg, backend=self.backend,
                                  device=self.device, mesh=self.mesh)
        with spans("write"):
            write_on_host0(self._write, res, prefix)
        return res.frag

    def _write(self, res, prefix: str) -> None:
        res.write_csv(prefix + ".frags.csv")
        res.write_family_summary(prefix + ".families.csv")
        res.write_intervals(prefix + ".repeats.bed")
        if self.mask:
            with open(prefix + ".masked.fasta", "w") as f:
                f.write(res.masked_fasta())
