"""Multi-process runs of the port's sharded backend: real OS processes, one
torch.distributed rank each, gloo collectives on the CPU (the counterpart
of tests/dist/test_multiprocess.py):

- the CLI across 2 ranks: rank 0 alone writes, and the files are
  byte-identical to a one-process ``--host-devices 2`` run and to the JAX
  package's output for the same file and flags;
- a 4-rank process mesh at (2, 2): every rank ends with the full table,
  equal to the JAX package's compare_sharded result, and rank 0 alone is
  the output host.

Every worker has its own hard timeout and is killed when it expires, so a
hang fails one test instead of the suite."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repkiller_tpu import cli as jcli
from repkiller_tpu.config import Config as JConfig
from repkiller_tpu.dist.mesh import make_mesh as j_make_mesh
from repkiller_tpu.dist.sharded import compare_sharded as j_compare_sharded
from repkiller_tpu.io import codec
from repkiller_tpu.utils import synth
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).parent / "_torch_mp_worker.py"
TIMEOUT = 120
CFG_FLAGS = ["--k", "12", "--strands", "fr", "--hit-capacity", str(1 << 12),
             "--max-extend", "128"]


def _free_port() -> int:
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(cmd):
    path = os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=path)
    return subprocess.Popen(cmd, cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(procs):
    """Wait for every worker within TIMEOUT seconds each, killing the rest
    on expiry -> [(rc, stdout, stderr)], all with rc 0."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:\n{out}\nstderr:\n{err}"
    return outs


def _ok_lines(outs, tag):
    lines = []
    for _, out, err in outs:
        ok = [ln.split() for ln in out.splitlines() if ln.startswith(tag)]
        assert ok, f"no {tag} line:\n{out}\n{err}"
        lines.append(ok[0])
    return lines


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    g = synth.plant(2000, [(100, 3, 0.04, 1), (60, 2, 0.0, 0)], seed=23)
    path = tmp_path_factory.mktemp("mp") / "g.fasta"
    path.write_text(">g\n" + codec.decode(g.codes) + "\n")
    return path


def test_two_process_cli_run(fasta, tmp_path):
    port = _free_port()
    base = [sys.executable, "-m", "repkiller_tpu_torch.cli", "run", str(fasta),
            "--backend", "sharded", "--device", "cpu", "--num-processes", "2",
            "--coordinator", f"127.0.0.1:{port}", *CFG_FLAGS]
    outs = _finish([
        _launch(base + ["--process-id", "0", "-o", str(tmp_path / "mp")]),
        _launch(base + ["--process-id", "1", "-o", str(tmp_path / "mp_r1")])])
    assert (tmp_path / "mp.frags.csv").exists()
    assert not list(tmp_path.glob("mp_r1.*"))          # rank 1 wrote nothing
    assert '"stage": "run"' in outs[0][1] and '"stage"' not in outs[1][1]

    _finish([_launch([sys.executable, "-m", "repkiller_tpu_torch.cli", "run",
                      str(fasta), "--backend", "sharded", "--device", "cpu",
                      "--host-devices", "2", "-o", str(tmp_path / "sp"),
                      *CFG_FLAGS])])
    assert jcli.main(["run", str(fasta), "--backend", "sharded",
                      "-o", str(tmp_path / "jax"), *CFG_FLAGS]) == 0
    for suffix in (".frags.csv", ".families.csv", ".repeats.bed"):
        got = (tmp_path / ("mp" + suffix)).read_bytes()
        assert got == (tmp_path / ("sp" + suffix)).read_bytes(), suffix
        assert got == (tmp_path / ("jax" + suffix)).read_bytes(), suffix
    assert len((tmp_path / "mp.frags.csv").read_bytes()) > 100


def test_four_rank_process_mesh(tmp_path):
    """Ranks 0-3 form a (2, 2) process mesh; each holds the full table."""
    g = synth.plant(3000, [(120, 3, 0.05, 1), (80, 2, 0.0, 0)], seed=11)
    cfg = JConfig(k=12, strands="fr", hit_capacity=1 << 12, max_extend=128)
    want = j_compare_sharded(g.codes, None, cfg, j_make_mesh(2, 2))
    assert want["xStart"].shape[0] > 0
    np.save(tmp_path / "g.npy", g.codes)
    np.savez(tmp_path / "want.npz", **want)
    port = _free_port()
    outs = _finish([_launch([sys.executable, str(WORKER), str(port),
                             str(r), "4", str(tmp_path / "g.npy"),
                             str(tmp_path / "want.npz")]) for r in range(4)])
    lines = _ok_lines(outs, "MESH_OK")
    assert len({ln[3] for ln in lines}) == 1
    assert [ln[2] for ln in lines] == ["1", "0", "0", "0"]
