"""The port's command line (``python -m repkiller_tpu_torch.cli``) against
the JAX package's: on the same FASTA files, ``run`` with ``--device cpu``
writes the fragments CSV, family summary, BED and masked FASTA byte for
byte as ``repkiller_tpu.cli run --backend oracle`` does (the oracle gives
the device backend's bytes, more cheaply), self and pairwise; the
``group`` round trip; ``--auto-capacity``; ``--profile``; and the flags of
paths not ported yet."""

import json
import os

import numpy as np
import pytest

from repkiller_tpu import cli as jcli
from repkiller_tpu.io import codec
from repkiller_tpu.utils import synth
from repkiller_tpu_torch import cli as tcli

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
    assert got.keys() == want.keys()
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


@pytest.mark.parametrize("flags,item", [
    (["--backend", "sharded"], "item 14"),
    (["--num-processes", "2", "--process-id", "0"], "item 14"),
    (["--platform", "cpu"], "item 14"),
    (["--host-devices", "4"], "item 14"),
    (["--keep-intermediates", "KEEP"], "item 11"),
    (["--stage-timing"], "item 15"),
])
def test_unported_flags_exit(fastas, tmp_path, flags, item):
    flags = [str(tmp_path / "k") if f == "KEEP" else f for f in flags]
    with pytest.raises(SystemExit, match=item):
        tcli.main(["run", fastas["x"], "-o", str(tmp_path / "o"), "--device",
                   "cpu", *flags])
    assert not os.path.exists(str(tmp_path / "o.frags.csv"))


def test_default_device_is_cuda(fastas, tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["run", fastas["x"], "-o", str(tmp_path / "o")])
    assert np.all([not os.path.exists(str(tmp_path / "o") + s)
                   for s in OUTPUTS])
