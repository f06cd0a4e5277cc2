"""The port's command line (``python -m repkiller_tpu_torch.cli``) against
the JAX package's: on the same FASTA files, ``run`` with ``--device cpu``
writes the fragments CSV, family summary, BED and masked FASTA byte for
byte as ``repkiller_tpu.cli run --backend oracle`` does (the oracle gives
the device backend's bytes, more cheaply), self and pairwise; the
``group`` round trip; ``--auto-capacity``; ``--profile``;
``--keep-intermediates`` (the reference's stage files, and a resume from
them); ``--stage-timing``; the run's trace spans in the metrics line;
``--backend sharded`` with ``--host-devices`` and ``--platform``; and the
flags the run refuses."""

import glob
import json
import os

import numpy as np
import pytest

from repkiller_tpu import cli as jcli
from repkiller_tpu.io import codec
from repkiller_tpu.utils import synth
from repkiller_tpu_torch import cli as tcli
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

OUTPUTS = (".frags.csv", ".families.csv", ".repeats.bed", ".masked.fasta")
FLAGS = ["--strands", "fr", "--hit-capacity", str(1 << 14), "--max-extend",
         "256", "--mask"]


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    """X with planted families (one inverted); Y a mutated stretch of X."""
    d = tmp_path_factory.mktemp("cli")
    g = synth.plant(8000, [(300, 3, 0.03, 1), (120, 4, 0.0, 1)], seed=21)
    y = g.codes[1500:7000].copy()
    y[::61] = (y[::61] + 1) % 4
    paths = {}
    for name, codes in (("x", g.codes), ("y", y)):
        p = d / f"{name}.fa"
        p.write_text(f">{name}\n" + codec.decode(codes) + "\n")
        paths[name] = str(p)
    return paths


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", ["ungapped", "banded"])
@pytest.mark.parametrize("pair", [False, True], ids=["self", "pair"])
def test_run_matches_reference_cli(fastas, tmp_path, capsys, mode, pair):
    inputs = [fastas["x"]] + ([fastas["y"]] if pair else [])
    flags = FLAGS + ["--extend-mode", mode]
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert tcli.main(["run", *inputs, "-o", ours, "--device", "cpu",
                      *flags]) == 0
    got = _last_json(capsys)
    assert jcli.main(["run", *inputs, "-o", ref, "--backend", "oracle",
                      *flags]) == 0
    want = _last_json(capsys)
    for suffix in OUTPUTS:
        with open(ours + suffix, "rb") as a, open(ref + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    assert got.keys() - {"spans"} == want.keys()
    assert got["fragments"] == want["fragments"] > 0
    assert got["families"] == want["families"] and got["bp"] == want["bp"]
    assert got["backend"] == "device"


@pytest.mark.parametrize("cross", [False, True])
def test_group_round_trip(fastas, tmp_path, capsys, cross):
    """``group`` on a run's CSV writes the same bytes as the reference's
    ``group``, and reproduces the run's own families."""
    inputs = [fastas["x"]] + ([fastas["y"]] if cross else [])
    run = str(tmp_path / "run")
    assert tcli.main(["run", *inputs, "-o", run, "--device", "cpu",
                      *FLAGS]) == 0
    ran = _last_json(capsys)
    extra = ["--cross"] if cross else []
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert tcli.main(["group", run + ".frags.csv", "-o", ours, *extra]) == 0
    got = _last_json(capsys)
    assert jcli.main(["group", run + ".frags.csv", "-o", ref, *extra]) == 0
    want = _last_json(capsys)
    assert got == want
    assert got["fragments"] == ran["fragments"] > 0
    assert got["families"] == ran["families"]
    for suffix in (".frags.csv", ".families.csv", ".repeats.bed"):
        with open(ours + suffix, "rb") as a, open(ref + suffix, "rb") as b:
            assert a.read() == b.read(), suffix


def test_auto_capacity_retry(tmp_path):
    """--auto-capacity N doubles the offending capacity and retries."""
    g = synth.plant(3000, [(120, 3, 0.02, 1)], seed=61)
    fa = tmp_path / "g.fasta"
    fa.write_text(">g\n" + codec.decode(g.codes) + "\n")
    base = ["run", str(fa), "-o", str(tmp_path / "o"), "--k", "12",
            "--strands", "fr", "--hit-capacity", "64", "--max-extend", "128",
            "--device", "cpu"]
    with pytest.raises(ValueError, match="overflow"):
        tcli.main(base)
    assert tcli.main(base + ["--auto-capacity", "8"]) == 0
    assert (tmp_path / "o.frags.csv").exists()


def test_profile_writes_a_trace(fastas, tmp_path, capsys):
    prof = tmp_path / "prof"
    assert tcli.main(["run", fastas["x"], "-o", str(tmp_path / "o"),
                      "--device", "cpu", "--profile", str(prof), *FLAGS]) == 0
    assert _last_json(capsys)["fragments"] > 0
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]


def test_run_reports_its_spans_and_profiles_the_writes(fastas, tmp_path,
                                                      capsys):
    """The metrics line and the --metrics-json record carry the host
    seconds of the run's trace spans by name, reading, comparing and
    writing alike; the --profile trace holds them as repkiller.* ranges,
    the writers' included."""
    prof, rec = tmp_path / "prof", tmp_path / "m.jsonl"
    assert tcli.main(["run", fastas["x"], "-o", str(tmp_path / "o"),
                      "--device", "cpu", "--profile", str(prof),
                      "--metrics-json", str(rec), *FLAGS]) == 0
    got = _last_json(capsys)
    assert json.loads(rec.read_text().splitlines()[-1]) == got
    spans = got["spans"]
    assert {"job", "io.read_fasta", "compare", "seeds", "extend", "merge",
            "copy_out", "families", "report.csv", "report.summary",
            "report.bed", "report.masked_fasta"} <= set(spans)
    assert all(0 <= v <= spans["job"] for v in spans.values())
    names = {e.get("name") for e in json.loads(
        (prof / "trace.json").read_text())["traceEvents"]}
    assert {"repkiller.job", "repkiller.compare", "repkiller.report.csv",
            "repkiller.report.bed", "repkiller.report.masked_fasta"} <= names


@pytest.mark.parametrize("flags,item", [
    (["--num-processes", "2"], "--process-id is required"),
    (["--num-processes", "2", "--process-id", "0"], "requires --backend sharded"),
    (["--platform", "tpu"], "--device"),
    (["--platform", "gpu", "--device", "cpu"], "--device"),
    (["--host-devices", "2", "--num-processes", "2", "--process-id", "0",
      "--backend", "sharded"], "--host-devices is a one-process mesh"),
])
def test_unported_flags_exit(fastas, tmp_path, flags, item):
    """The multi-process and runtime flags that the run refuses, before it
    reads input or joins a process group: the reference's refusals, and
    --platform values with no torch meaning or against --device."""
    with pytest.raises(SystemExit, match=item):
        tcli.main(["run", fastas["x"], "-o", str(tmp_path / "o"), "--device",
                   "cpu", *flags])
    assert not os.path.exists(str(tmp_path / "o.frags.csv"))


def test_stdin_refused_with_num_processes(tmp_path):
    with pytest.raises(SystemExit, match="stdin input"):
        tcli.main(["run", "-", "-o", str(tmp_path / "o"), "--device", "cpu",
                   "--backend", "sharded", "--num-processes", "2",
                   "--process-id", "0"])


@pytest.mark.parametrize("runtime", [["--platform", "cpu", "--device", "cuda"],
                                     ["--host-devices", "4", "--device", "cpu"]],
                         ids=["platform", "host-devices"])
def test_sharded_run_matches_reference_cli(fastas, tmp_path, capsys, runtime):
    """``--backend sharded`` on a one-process mesh (``--host-devices``) or
    with ``--platform cpu`` selecting the device writes the reference's
    bytes."""
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert tcli.main(["run", fastas["x"], "-o", ours, "--backend", "sharded",
                      *runtime, *FLAGS]) == 0
    got = _last_json(capsys)
    assert jcli.main(["run", fastas["x"], "-o", ref, "--backend", "oracle",
                      *FLAGS]) == 0
    want = _last_json(capsys)
    for suffix in OUTPUTS:
        with open(ours + suffix, "rb") as a, open(ref + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    assert got["backend"] == "sharded" and got["fragments"] == want["fragments"] > 0


def _stage_arrays(d):
    """{file name: {key: array}} of a --keep-intermediates directory."""
    out = {}
    for p in sorted(glob.glob(os.path.join(d, "stage_*.npz"))):
        with np.load(p) as z:
            out[os.path.basename(p)] = {f: z[f] for f in z.files}
    return out


@pytest.mark.parametrize("pair", [False, True], ids=["self", "pair"])
def test_keep_intermediates_matches_reference_cli(fastas, tmp_path, capsys,
                                                  pair):
    """The port and ``repkiller_tpu.cli`` with --keep-intermediates write
    the same outputs and the same stage files (names, keys, dtypes,
    arrays); the port then resumes from the reference's directory without
    writing to it, and gives the same bytes again."""
    inputs = [fastas["x"]] + ([fastas["y"]] if pair else [])
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    keep_ours, keep_ref = str(tmp_path / "k_ours"), str(tmp_path / "k_ref")
    assert tcli.main(["run", *inputs, "-o", ours, "--device", "cpu",
                      "--keep-intermediates", keep_ours, *FLAGS]) == 0
    assert jcli.main(["run", *inputs, "-o", ref, "--keep-intermediates",
                      keep_ref, *FLAGS]) == 0
    capsys.readouterr()
    got, want = _stage_arrays(keep_ours), _stage_arrays(keep_ref)
    assert list(got) == list(want) and len(got) == 4
    for name in want:
        assert got[name].keys() == want[name].keys(), name
        for f, a in want[name].items():
            assert got[name][f].dtype == a.dtype and np.array_equal(
                got[name][f], a), (name, f)
    stamps = {p: os.stat(p).st_mtime_ns
              for p in glob.glob(os.path.join(keep_ref, "*"))}
    again = str(tmp_path / "again")
    assert tcli.main(["run", *inputs, "-o", again, "--device", "cpu",
                      "--keep-intermediates", keep_ref, *FLAGS]) == 0
    assert {p: os.stat(p).st_mtime_ns
            for p in glob.glob(os.path.join(keep_ref, "*"))} == stamps
    for suffix in OUTPUTS:
        with open(ref + suffix, "rb") as b:
            want_bytes = b.read()
        for prefix in (ours, again):
            with open(prefix + suffix, "rb") as a:
                assert a.read() == want_bytes, (prefix, suffix)


def test_stage_timing_prints_records(fastas, tmp_path, capsys):
    """--stage-timing prints the reference's per-stage JSONL records (all
    but ``wall_s`` equal), then the run's metrics line."""
    flags = ["--stage-timing", *FLAGS]
    assert tcli.main(["run", fastas["x"], "-o", str(tmp_path / "ours"),
                      "--device", "cpu", *flags]) == 0
    got = [json.loads(line) for line in
           capsys.readouterr().out.strip().splitlines()]
    assert jcli.main(["run", fastas["x"], "-o", str(tmp_path / "ref"),
                      "--backend", "oracle", *flags]) == 0
    want = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["stage"] for r in got] == [
        "h2d", "index_build", "seed_join", "hit_filter", "extension",
        "merge_accept", "families_host", "run"]
    for g, w in zip(got[:-1], want[:-1], strict=True):
        g.pop("wall_s"), w.pop("wall_s")
        assert g == w
    assert got[2]["hits"] > 0 and got[-1]["fragments"] == want[-1]["fragments"]


def test_default_device_is_cuda(fastas, tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["run", fastas["x"], "-o", str(tmp_path / "o")])
    assert np.all([not os.path.exists(str(tmp_path / "o") + s)
                   for s in OUTPUTS])
