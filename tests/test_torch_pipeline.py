"""End-to-end self-comparison of the torch port on the CPU against the JAX
device pipeline and the numpy oracle; the golden files byte for byte; the
overflow and edge-case contract; and the proof that the port never
imports JAX. Integer outputs: exact equality."""

import dataclasses
import functools
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repkiller_tpu import device as jdevice
from repkiller_tpu.chain.diagonal import extend_gated as j_extend_gated
from repkiller_tpu.chain.merge import merge_accept as j_merge
from repkiller_tpu.config import Config as JConfig
from repkiller_tpu.oracle import pipeline as orc
from repkiller_tpu.utils import synth
from repkiller_tpu_torch import api, device as tdevice
from repkiller_tpu_torch.chain.merge import merge_accept as t_merge
from repkiller_tpu_torch.config import Config
from repkiller_tpu_torch.convert import to_numpy, to_torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"
CFG = Config(k=12, strands="fr", extend_mode="banded", band=8,
             hit_capacity=1 << 13, max_extend=512)


def _ref(cfg: Config) -> JConfig:
    """The JAX package's Config with the same fields, for its calls."""
    return JConfig(**dataclasses.asdict(cfg))


def _genome(seed, L=6000):
    return synth.plant(L, [(400, 3, 0.03, 1), (150, 4, 0.0, 1),
                           (80, 3, 0.06, 0)], seed=seed).codes


def _assert_frag_equal(got, want):
    for f in list(orc.FRAG_FIELDS) + ["group"]:
        assert np.array_equal(got[f], want[f]), (f, got[f][:10], want[f][:10])


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_extension(cx, cfg):
    """Both strands' gated extension output of the JAX package."""
    frags, valids = [], []
    for strand, (spx, spy, sv, n_seeds, _) in jdevice.self_seeds_fn(cx, cfg).items():
        cy = cx if strand == 0 else jdevice.revcomp_device(cx)
        frag, fv = j_extend_gated(spx, spy, sv, cx, cy, cfg, n_live=n_seeds)
        frag["strand"] = jnp.where(fv, strand, 0)
        frags.append(frag)
        valids.append(fv)
    frag = {f: jnp.concatenate([fr[f] for fr in frags]) for f in frags[0]}
    return frag, jnp.concatenate(valids)


def test_merge_accept_on_jax_extension_output():
    """The JAX package's extension output, carried over with
    convert.to_torch, merged by both implementations."""
    cfg = CFG.replace(max_extend=256)
    cx = jnp.asarray(_genome(41))
    frag, valid = _jax_extension(cx, _ref(cfg))
    frag = {f: np.asarray(v) for f, v in frag.items()}
    valid = np.asarray(valid)
    want = j_merge({f: jnp.asarray(v) for f, v in frag.items()},
                   jnp.asarray(valid), cfg.min_len, cfg.min_identity,
                   y_len=cx.shape[0])
    got = t_merge(to_torch(frag, "cpu"), to_torch(valid, "cpu"), cfg.min_len,
                  cfg.min_identity, y_len=cx.shape[0])
    for f in want[0]:
        assert np.array_equal(to_numpy(got[0][f]), np.asarray(want[0][f])), f
    assert np.array_equal(to_numpy(got[1]), np.asarray(want[1]))
    assert int(got[2]) == int(want[2]) > 0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_compare_matches_jax_device_and_oracle(seed):
    codes = _genome(seed)
    got = tdevice.compare(codes, None, CFG, "cpu")
    _assert_frag_equal(got, orc.compare(codes, None, _ref(CFG)))
    _assert_frag_equal(got, jdevice.compare(codes, None, _ref(CFG)))
    assert got["xStart"].shape[0] > 0 and (got["strand"] == 1).any()


def test_compare_ungated_matches_oracle():
    codes = _genome(4)
    cfg = CFG.replace(gate_stride=0, max_extend=256)
    _assert_frag_equal(tdevice.compare(codes, None, cfg, "cpu"),
                       orc.compare(codes, None, _ref(cfg)))


def test_golden_outputs_byte_identical():
    cfg = Config(k=12, strands="fr", hit_capacity=1 << 14, max_extend=512,
                 extend_mode="banded", band=8)
    res = api.compare(str(GOLDEN / "golden30k.fasta"), cfg=cfg, device="cpu")
    buf = io.StringIO()
    res.write_csv(buf)
    assert buf.getvalue() == (GOLDEN / "golden30k.frags.csv").read_text()
    buf = io.StringIO()
    res.write_intervals(buf)
    assert buf.getvalue() == (GOLDEN / "golden30k.repeats.bed").read_text()


def test_hit_capacity_overflow_raises():
    cfg = Config(k=8, max_occ=10000, hit_capacity=64, max_extend=128,
                 extend_mode="banded")
    with pytest.raises(ValueError, match="hit_capacity"):
        tdevice.compare(np.zeros(200, np.uint8), None, cfg, "cpu")


def test_seed_capacity_overflow_raises():
    cfg = CFG.replace(seed_capacity=16)
    with pytest.raises(ValueError, match="seed_capacity"):
        tdevice.compare(_genome(5), None, cfg, "cpu")


def test_fragment_capacity_overflow_raises():
    """Two copies of a unit between N blocks: one seed, one accepted
    fragment, which fills a one-slot fragment array."""
    unit = synth.random_codes(300, seed=8)
    gap = np.full(50, 4, np.uint8)
    codes = np.concatenate([unit, gap, unit])
    cfg = Config(k=12, strands="f", extend_mode="banded", min_hit_dist=4096,
                 hit_capacity=512, seed_capacity=1, max_extend=512)
    with pytest.raises(ValueError, match="frag capacity"):
        tdevice.compare(codes, None, cfg, "cpu")
    ok = tdevice.compare(codes, None, cfg.replace(seed_capacity=2), "cpu")
    _assert_frag_equal(ok, orc.compare(codes, None, _ref(cfg)))


@pytest.mark.parametrize("name,codes,cfg", [
    ("empty", np.zeros(0, np.uint8), CFG),
    ("shorter than k", np.array([0, 1, 2, 3, 0], np.uint8), CFG),
    ("all N", np.full(3000, 4, np.uint8), CFG),
    ("poly-A small max_occ", np.zeros(3000, np.uint8), CFG.replace(max_occ=8)),
])
def test_edge_inputs(name, codes, cfg):
    got = tdevice.compare(codes, None, cfg, "cpu")
    assert got["xStart"].shape[0] == 0, name
    _assert_frag_equal(got, orc.compare(codes, None, _ref(cfg)))


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.compare(_genome(6, L=2000), cfg=CFG)


def test_unported_paths_raise(tmp_path):
    """keep_intermediates with a backend other than "device" raises the
    reference's ValueError, the sharded backend's included; an unknown
    backend raises too."""
    codes = _genome(7, L=2000)
    for backend in ("oracle", "sharded"):
        with pytest.raises(ValueError, match="requires the device backend"):
            api.compare(codes, None, CFG, backend, str(tmp_path), device="cpu")
    assert not os.listdir(tmp_path)
    with pytest.raises(ValueError, match="unknown backend"):
        api.compare(codes, None, CFG, "streamed", device="cpu")


NO_JAX = """
import sys
sys.modules["jax"] = None          # any import of jax now raises ImportError,
sys.modules["repkiller_tpu"] = None  # and so does any of the JAX package
sys.path.insert(0, {root!r})
import repkiller_tpu_torch
import repkiller_tpu_torch.cli
import repkiller_tpu_torch.dist.windows
import repkiller_tpu_torch.utils.checkpoint
import repkiller_tpu_torch.utils.metrics
import repkiller_tpu_torch.dist.merge
from repkiller_tpu_torch.dist.mesh import make_mesh
from repkiller_tpu_torch.dist.sharded import compare_sharded
import chip_smoke                  # imported, main() not run
from repkiller_tpu_torch.config import Config
from repkiller_tpu_torch.io import codec
from repkiller_tpu_torch.utils import synth
g = synth.plant(5000, [(300, 3, 0.03, 1)], seed=3)
y = g.codes[500:4500].copy()                        # shares X's sequence
y[::97] = (y[::97] + 1) % 4
banded = Config(k=12, strands="fr", extend_mode="banded", hit_capacity=1 << 13)
for cfg in (banded, Config()):                      # Config(): ungapped
    for y in (None, y):
        res = repkiller_tpu_torch.compare(g.codes, y, cfg, device="cpu")
        assert res.n_fragments > 0, (cfg.extend_mode, y is None)
        print(cfg.extend_mode, "self" if y is None else "pair",
              "fragments", res.n_fragments)
sharded = compare_sharded(g.codes, None, banded, make_mesh(2, 2, ["cpu"] * 4))
print("sharded self fragments", sharded["xStart"].shape[0])
fa = {tmp!r} + "/g.fa"
open(fa, "w").write(">g\\n" + codec.decode(g.codes) + "\\n")
assert repkiller_tpu_torch.cli.main(
    ["run", fa, "-o", {tmp!r} + "/o", "--device", "cpu"]) == 0
"""


def test_port_never_imports_jax(tmp_path):
    """With jax and the JAX package blocked: the banded and the default
    (ungapped) Config, self and pairwise, the sharded backend on a (2, 2)
    CPU mesh, and the CLI's run; and no line of
    the port or of chip_smoke.py imports either."""
    code = NO_JAX.format(root=str(ROOT), tmp=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})  # as _torch_threads
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count(" fragments ") == 5, proc.stdout
    assert '"stage": "run"' in proc.stdout, proc.stdout
    assert (tmp_path / "o.frags.csv").exists()
    pattern = re.compile(r"import jax|from jax|"
                         r"^\s*(from|import) repkiller_tpu(\.| |$)")
    files = [ROOT / "chip_smoke.py"] + sorted((ROOT / "repkiller_tpu_torch").rglob("*.py"))
    hits = [f"{p}:{i}" for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert not hits, hits
