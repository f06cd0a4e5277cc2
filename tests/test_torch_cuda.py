"""Tests of the torch port that need an NVIDIA GPU: kernels K1 and K2
against their plain versions on the card, and the pipeline on the card
(self and pairwise, banded and ungapped) against the CPU.

They skip where no GPU is visible; on a machine with one, run
    python -m pytest tests/test_torch_cuda.py -q
This file imports no JAX, so it also runs where JAX is not installed.
Integer outputs: exact equality."""

import numpy as np
import pytest
import torch

from repkiller_tpu.config import Config
from repkiller_tpu.utils import synth
from repkiller_tpu_torch import device as tdevice
from repkiller_tpu_torch.extend import _cuda, ungapped
from repkiller_tpu_torch.extend.banded import direction_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _case(seed, dev, n=1000, L=8000):
    rng = np.random.default_rng(seed)
    cx = rng.integers(0, 4, L, dtype=np.uint8)
    cy = cx.copy()
    mut = rng.random(L) < 0.03
    cy[mut] = (cy[mut] + rng.integers(1, 4, mut.sum())) % 4
    cy[L // 2:] = np.roll(cy[L // 2:], 2)
    cx[1000:1008] = 4
    px = rng.integers(0, L - 12, n).astype(np.int32)
    py = np.clip(px + rng.integers(-3, 4, n), 0, L - 12).astype(np.int32)
    px[:2] = py[:2] = [0, L - 12]
    valid = rng.random(n) > 0.05
    n_live = n - 11
    valid[n_live:] = False
    return [torch.from_numpy(a).to(dev) for a in (px, py, valid, cx, cy)], n_live


@pytest.mark.parametrize("band", [4, 8, 15, 16, 32])
@pytest.mark.parametrize("E,extra", [(192, "band"), (256, 0)])
def test_kernel_matches_plain(gpu, band, E, extra):
    inputs, n_live = _case(band, gpu)
    jcap = E + band if extra == "band" else E
    for base_off, step in ((12, +1), (-1, -1)):
        args = (base_off, step, 4, -4, 40, E, band, 8, 2, jcap)
        before = _cuda.banded_gotoh.launches
        got = _cuda.banded_gotoh(*inputs, *args, torch.tensor(n_live, device=gpu))
        assert _cuda.banded_gotoh.launches == before + 1
        want = direction_plain(*inputs, *args, n_live)
        for name, g, w in zip(("ei", "ej", "gain", "idents", "alive"), got, want):
            assert torch.equal(g, w), (band, E, step, name)


@pytest.mark.parametrize("band", [40, 100])
@pytest.mark.parametrize("E,extra", [(192, "band"), (512, 0)])
def test_kernel_matches_plain_wide_band(gpu, band, E, extra):
    """Rows wider than 65 cells run in the global-scratch variant of K1."""
    inputs, n_live = _case(band, gpu)
    jcap = E + band if extra == "band" else E
    for base_off, step in ((12, +1), (-1, -1)):
        args = (base_off, step, 4, -4, 40, E, band, 8, 2, jcap)
        before = _cuda.banded_gotoh.launches
        got = _cuda.banded_gotoh(*inputs, *args, torch.tensor(n_live, device=gpu))
        assert _cuda.banded_gotoh.launches == before + 1
        want = direction_plain(*inputs, *args, n_live)
        for name, g, w in zip(("ei", "ej", "gain", "idents", "alive"), got, want):
            assert torch.equal(g, w), (band, E, step, name)
        assert (got[0] != got[1]).any()


@pytest.mark.parametrize("E", [64, 256, 2048])
@pytest.mark.parametrize("x_drop", [12, 40])
def test_ungapped_kernel_matches_plain(gpu, E, x_drop):
    inputs, n_live = _case(E + x_drop, gpu)
    for base_off, step in ((12, +1), (-1, -1)):
        args = (base_off, step, 4, -4, x_drop, E)
        before = _cuda.ungapped_xdrop.launches
        got = _cuda.ungapped_xdrop(*inputs, *args,
                                   torch.tensor(n_live, device=gpu))
        assert _cuda.ungapped_xdrop.launches == before + 1
        want = ungapped.direction_plain(*inputs, *args, n_live)
        for name, g, w in zip(("ext", "gain", "idents"), got, want):
            assert torch.equal(g, w), (E, x_drop, step, name)
        assert (got[0] > 0).any()


def test_pipeline_on_card_matches_cpu(gpu):
    g = synth.plant(20000, [(400, 3, 0.03, 1), (150, 4, 0.0, 1)], seed=2)
    cfg = Config(k=12, strands="fr", extend_mode="banded",
                 hit_capacity=1 << 14, max_extend=512)
    before = _cuda.banded_gotoh.launches
    got = tdevice.compare(g.codes, None, cfg, gpu)
    assert _cuda.banded_gotoh.launches > before
    want = tdevice.compare(g.codes, None, cfg, "cpu")
    assert got["xStart"].shape[0] > 0
    for f in want:
        assert np.array_equal(got[f], want[f]), f


def test_ungapped_pipeline_on_card_matches_cpu(gpu):
    """The default Config (ungapped) with both strands, self-comparison."""
    g = synth.plant(20000, [(400, 3, 0.03, 1), (150, 4, 0.0, 1)], seed=3)
    cfg = Config(strands="fr", hit_capacity=1 << 14)
    k1, k2 = _cuda.banded_gotoh.launches, _cuda.ungapped_xdrop.launches
    got = tdevice.compare(g.codes, None, cfg, gpu)
    assert _cuda.ungapped_xdrop.launches > k2
    assert _cuda.banded_gotoh.launches == k1
    want = tdevice.compare(g.codes, None, cfg, "cpu")
    assert got["xStart"].shape[0] > 0
    for f in want:
        assert np.array_equal(got[f], want[f]), f


@pytest.mark.parametrize("mode", ["ungapped", "banded"])
def test_pairwise_pipeline_on_card_matches_cpu(gpu, mode):
    g = synth.plant(20000, [(400, 3, 0.03, 1), (150, 4, 0.0, 1)], seed=4)
    y = g.codes[3000:17000].copy()
    y[::37] = (y[::37] + 1) % 4
    cfg = Config(k=12, strands="fr", extend_mode=mode, hit_capacity=1 << 15,
                 max_extend=512)
    kernel = _cuda.ungapped_xdrop if mode == "ungapped" else _cuda.banded_gotoh
    before = kernel.launches
    got = tdevice.compare(g.codes, y, cfg, gpu)
    assert kernel.launches > before
    want = tdevice.compare(g.codes, y, cfg, "cpu")
    assert got["xStart"].shape[0] > 0 and (got["strand"] == 1).any()
    for f in want:
        assert np.array_equal(got[f], want[f]), f
