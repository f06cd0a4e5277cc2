"""Command-line driver of the port: ``python -m repkiller_tpu_torch.cli``.

The subcommands and flags are those of ``repkiller_tpu.cli`` (the parser
below is its copy, over the port's own ``Config``), plus ``run --device``
(default ``cuda``; without a GPU that raises, pass ``--device cpu`` to run
on the CPU):

  run    FASTA (self, or a pair) -> fragments CSV, family summary, repeat
         intervals BED, optional masked FASTA, and one JSON metrics line
  group  fragments CSV -> family-annotated CSV, summary and intervals

Flags map 1:1 onto Config fields. ``--profile DIR`` writes a
torch.profiler trace of the comparison and the writes to DIR/trace.json,
the program's trace spans among them as ``repkiller.*`` ranges;
``--keep-intermediates DIR`` dumps each stage's arrays and resumes from
them; ``--stage-timing`` also prints per-stage JSONL timings. The metrics
line's "spans" holds the host seconds of the run's trace spans
(utils/trace.py) by name.

``--backend sharded`` runs the (data, shard) mesh pipeline. Across
processes: ``--num-processes N --process-id i --coordinator host:port``,
one rank each (nccl on CUDA, gloo on the CPU); every rank runs the whole
comparison, rank 0 alone writes the outputs and prints the metrics line.
The reference's two JAX runtime flags take these torch meanings:
``--host-devices N`` is the number of (data, shard) bodies of a
one-process mesh, all on ``--device`` (the reference's virtual devices);
``--platform cpu|gpu|cuda`` selects ``--device``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import sys
import time
from collections import defaultdict

import numpy as np

from . import api
from .config import Config
from .report import csv_writer, intervals as report_iv
from .utils import trace
from .utils.capacity import grow_capacity
from .utils.metrics import profile_stages

log = logging.getLogger("repkiller_tpu")


def _add_config_flags(p: argparse.ArgumentParser) -> None:
    for f in dataclasses.fields(Config):
        flag = "--" + f.name.replace("_", "-")
        if f.type == "str" or isinstance(f.default, str):
            p.add_argument(flag, type=str, default=f.default)
        elif isinstance(f.default, bool):
            p.add_argument(flag, type=int, default=int(f.default))
        elif isinstance(f.default, float):
            p.add_argument(flag, type=float, default=f.default)
        else:
            p.add_argument(flag, type=int, default=f.default)


def _config_from_args(args: argparse.Namespace) -> Config:
    return Config(**{f.name: getattr(args, f.name)
                     for f in dataclasses.fields(Config)})


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repkiller_tpu_torch.cli",
        description="Repeat detection on PyTorch and CUDA (capabilities of "
                    "estebanpw/repkiller)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="full comparison pipeline")
    pr.add_argument("fasta_x", help="query FASTA (or '-' for stdin)")
    pr.add_argument("fasta_y", nargs="?", default=None,
                    help="optional second FASTA; omitted = self-comparison")
    pr.add_argument("-o", "--out-prefix", default="out",
                    help="output file prefix")
    pr.add_argument("--backend", choices=("device", "sharded", "oracle"),
                    default="device")
    pr.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; raises "
                         "without a GPU)")
    pr.add_argument("--mask", action="store_true",
                    help="also write <prefix>.masked.fasta")
    pr.add_argument("--coords", choices=("concat", "record"),
                    default="concat",
                    help="fragment CSV coordinate space for multi-record "
                         "inputs: concatenated (round-trip canonical) or "
                         "record-local (per-chromosome, GECKO-consumer "
                         "dialect)")
    pr.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace to DIR/trace.json")
    pr.add_argument("--metrics-json", default=None,
                    help="append a JSONL metrics record here")
    pr.add_argument("--keep-intermediates", default=None, metavar="DIR",
                    help="dump each stage's arrays to DIR; a rerun with "
                         "identical inputs resumes from the last completed "
                         "stage (device backend)")
    pr.add_argument("--auto-capacity", type=int, default=0, metavar="N",
                    help="on capacity overflow, double the offending "
                         "capacity and retry, up to N times. 0 = fail fast "
                         "with the measured counts")
    pr.add_argument("--stage-timing", action="store_true",
                    help="also run the pipeline stage-by-stage and print "
                         "per-stage JSONL timings (forward strand)")
    pr.add_argument("--num-processes", type=int, default=1,
                    help="total processes of a multi-process sharded run")
    pr.add_argument("--process-id", type=int, default=None,
                    help="this process's rank")
    pr.add_argument("--coordinator", default="127.0.0.1:29477",
                    help="rank-0 coordinator address host:port")
    pr.add_argument("--platform", default=None,
                    help="cpu, gpu or cuda: the same as --device cpu or cuda")
    pr.add_argument("--host-devices", type=int, default=None,
                    help="bodies of a one-process sharded mesh, all on "
                         "--device")
    _add_config_flags(pr)

    pg = sub.add_parser("group", help="cluster an existing fragments CSV")
    pg.add_argument("frags_csv")
    pg.add_argument("-o", "--out-prefix", default="grouped")
    pg.add_argument("--cross", action="store_true",
                    help="fragments come from a two-genome comparison")
    _add_config_flags(pg)
    return p


_PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def _init_runtime(args: argparse.Namespace) -> None:
    """The reference's refusals and multi-process bring-up, and the torch
    meanings of --platform (it sets the type of --device, whose default
    cuda it may override) and --host-devices."""
    if args.platform is not None:
        want = _PLATFORMS.get(args.platform)
        have = args.device.split(":")[0]
        if want is None or (want != have and args.device != "cuda"):
            raise SystemExit(
                f"--platform {args.platform} does not select --device "
                f"{args.device}: the port runs on a torch device, so use "
                "--device (cpu, cuda or cuda:N); --platform takes cpu, gpu "
                "or cuda")
        if want != have:
            args.device = want
    if args.num_processes > 1:
        if args.process_id is None:
            raise SystemExit("--process-id is required with --num-processes")
        if args.backend != "sharded":
            raise SystemExit("--num-processes>1 requires --backend sharded")
        if args.fasta_x == "-":
            # each rank would read its own stdin, and launchers feed only
            # rank 0: the ranks would build different "replicated" inputs
            raise SystemExit("stdin input ('-') is not supported with "
                             "--num-processes>1; pass a file path visible "
                             "to every rank")
        if args.host_devices:
            raise SystemExit("--host-devices is a one-process mesh; with "
                             "--num-processes>1 each rank holds one body")
        from .dist.mesh import init_distributed
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id, device=args.device)


@contextlib.contextmanager
def _profiled(out_dir, device: str):
    """torch.profiler trace of the block, written to out_dir/trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def cmd_run(args: argparse.Namespace) -> int:
    cfg = _config_from_args(args)
    _init_runtime(args)
    mesh = None
    if args.host_devices:
        from .dist.mesh import make_mesh
        mesh = make_mesh(devices=[args.device] * args.host_devices)
    src_x = sys.stdin.read() if args.fasta_x == "-" else args.fasta_x
    from .dist.merge import is_output_host, write_on_host0

    prefix = args.out_prefix

    def _write_all():
        res.write_csv(prefix + ".frags.csv", coords=args.coords)
        res.write_family_summary(prefix + ".families.csv")
        res.write_intervals(prefix + ".repeats.bed")
        if args.mask:
            with open(prefix + ".masked.fasta", "w") as f:
                f.write(res.masked_fasta())

    profile_ctx = (_profiled(args.profile, args.device) if args.profile
                   else contextlib.nullcontext())
    with profile_ctx, trace.job() as job_id:
        t0 = time.perf_counter()
        for attempt in range(args.auto_capacity + 1):
            try:
                res = api.compare(src_x, args.fasta_y, cfg,
                                  backend=args.backend,
                                  keep_intermediates=args.keep_intermediates,
                                  device=args.device, mesh=mesh)
                break
            except ValueError as e:
                grown = grow_capacity(cfg, str(e))
                if grown is None or attempt == args.auto_capacity:
                    raise
                log.warning("%s — retrying with %s (attempt %d/%d)",
                            e, grown[1], attempt + 1, args.auto_capacity)
                cfg = grown[0]
        dt = time.perf_counter() - t0
        write_on_host0(_write_all)

    if args.stage_timing:
        profile_stages(res.x.codes, None if res.self_cmp else res.y.codes,
                       cfg, emit=print, device=args.device)

    bp = res.x.total_length + (0 if res.self_cmp else res.y.total_length)
    metrics = {
        "stage": "run", "wall_s": round(dt, 4), "bp": bp,
        "bp_per_s": round(bp / dt, 1),
        "fragments": res.n_fragments, "families": res.n_families,
        "backend": args.backend, "spans": job_spans(job_id),
    }
    log.info("run: %s", metrics)
    if is_output_host():
        print(json.dumps(metrics))
        if args.metrics_json:
            with open(args.metrics_json, "a") as f:
                f.write(json.dumps(metrics) + "\n")
    return 0


def job_spans(job_id: int) -> dict:
    """Host seconds by span name over the trace spans of job ``job_id``."""
    secs = defaultdict(float)
    for s in trace.spans():
        if s["job"] == job_id:
            secs[s["name"]] += s["t1"] - s["t0"]
    return {name: round(v, 6) for name, v in sorted(secs.items())}


def cmd_group(args: argparse.Namespace) -> int:
    cfg = _config_from_args(args)
    self_cmp = not args.cross
    frag = api.group_fragments(args.frags_csv, cfg, self_cmp=self_cmp)
    prefix = args.out_prefix
    csv_writer.write_frags_csv(frag, prefix + ".frags.csv")
    report_iv.write_family_summary(frag, prefix + ".families.csv")
    report_iv.write_intervals_bed(frag, cfg, prefix + ".repeats.bed",
                                  self_cmp=self_cmp)
    n_frag = int(frag["xStart"].shape[0])
    n_fam = int(np.unique(frag["group"]).shape[0]) if n_frag else 0
    print(json.dumps({"stage": "group", "fragments": n_frag,
                      "families": n_fam}))
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    if args.cmd != "run":
        return cmd_group(args)
    from .dist.mesh import process_group_active
    try:
        return cmd_run(args)
    finally:
        if process_group_active():        # joined by --num-processes
            import torch.distributed as dist
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
