"""Tests of the torch port that need an NVIDIA GPU: kernels K1 and K2
against their plain versions on the card, and the pipeline on the card
(self and pairwise, banded and ungapped) against the CPU.

They skip where no GPU is visible; on a machine with one, run
    python -m pytest tests/test_torch_cuda.py -q
This file imports no JAX and nothing of the JAX package, so it also runs
where JAX is not installed. Integer outputs: exact equality."""

import numpy as np
import pytest
import torch

from repkiller_tpu_torch import device as tdevice
from repkiller_tpu_torch.config import Config
from repkiller_tpu_torch.extend import _cuda, ungapped
from repkiller_tpu_torch.extend.banded import direction_plain
from repkiller_tpu_torch.utils import synth

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


def _check_k1(inputs, n_live, band, E, jcap, gpu, x_drop=40,
              scores=(4, -4, 8, 2)):
    """K1 against the plain version on both directions; ``scores`` is
    (match, mismatch, gap_open, gap_extend) -> the kernel's outputs per
    direction."""
    match, mismatch, gap_open, gap_extend = scores
    outs = []
    for base_off, step in ((12, +1), (-1, -1)):
        args = (base_off, step, match, mismatch, x_drop, E, band, gap_open,
                gap_extend, jcap)
        before = _cuda.banded_gotoh.launches
        got = _cuda.banded_gotoh(*inputs, *args, torch.tensor(n_live, device=gpu))
        assert _cuda.banded_gotoh.launches == before + 1
        want = direction_plain(*inputs, *args, n_live)
        for name, g, w in zip(("ei", "ej", "gain", "idents", "alive"), got, want):
            assert torch.equal(g, w), (band, E, step, name)
        outs.append(got)
    return outs


# 15/16, 31/32 and 47/48: the edges of 1, 2 and 3 band cells per lane of
# the warp kernel, and of the wide kernel past 96 cells
@pytest.mark.parametrize("band", [4, 8, 15, 16, 31, 32, 47, 48])
@pytest.mark.parametrize("E,extra", [(192, "band"), (256, 0)])
def test_kernel_matches_plain(gpu, band, E, extra):
    inputs, n_live = _case(band, gpu)
    jcap = E + band if extra == "band" else E
    _check_k1(inputs, n_live, band, E, jcap, gpu)


# (match, mismatch, gap_open, gap_extend, x_drop): gap_extend 0, where
# every w of a row's gap scan ties and the last cell must win; a large
# gap_open; match != -mismatch; an x_drop far past the furthest a live
# value can fall (the drop switched off); a negative x_drop, which prunes
# every cell at row 0
SCORES = [(4, -4, 8, 0, 40), (4, -4, 60, 2, 40), (1, -3, 5, 2, 20),
          (2, -7, 8, 1, 25), (4, -4, 8, 2, 2**31 - 1), (4, -4, 8, 2, -3)]


@pytest.mark.parametrize("band", [8, 15, 31, 47])
@pytest.mark.parametrize("setting", SCORES)
def test_kernel_matches_plain_scores(gpu, band, setting):
    inputs, n_live = _case(band + 100, gpu)
    outs = _check_k1(inputs, n_live, band, 192, 192 + band, gpu,
                     x_drop=setting[4], scores=setting[:4])
    if setting[4] < 0:
        assert not any(torch.stack(o).any() for o in outs)


def test_kernel_matches_plain_at_the_key_edge(gpu):
    """Scores just inside the warp kernel's key range (E 192, band 15:
    7,900,500 of 2^23) with the drop off, so values spread as far as the
    scores let them."""
    inputs, n_live = _case(7, gpu)
    _check_k1(inputs, n_live, 15, 192, 207, gpu, x_drop=2**31 - 1,
              scores=(4000, -4000, 1000, 500))


def test_kernel_refuses_scores_past_its_keys(gpu):
    """Scores whose values could leave the packed keys raise, naming the
    limit, before any launch; the plain version has no such limit."""
    inputs, n_live = _case(1, gpu)
    before = _cuda.banded_gotoh.launches
    with pytest.raises(ValueError, match=r"reaches 2\^23"):
        _cuda.banded_gotoh(*inputs, 12, 1, 8000, -8000, 40, 192, 15, 1000,
                           500, 207, n_live)
    assert _cuda.banded_gotoh.launches == before
    # rows wider than the warp kernel's run in the wide kernel: no limit
    _check_k1(inputs, n_live, 48, 192, 240, gpu, scores=(8000, -8000, 1000, 500))


@pytest.mark.parametrize("band", [8, 15, 31, 47])
def test_kernel_one_seed_to_the_cap(gpu, band):
    """Two seeds on identical sequences run every row to the cap while their
    block neighbours, whose y bases are all N, die at row 1 (a mismatch
    falls below x_drop 3), in both directions."""
    L, E = 4000, 512
    rng = np.random.default_rng(band)
    cx = rng.integers(0, 4, L, dtype=np.uint8)
    cy = cx.copy()
    cy[1800:2200] = 4
    n = 24
    px = np.full(n, 2000, np.int32)
    long = [5, 13]
    px[long] = [600, 3000]
    inputs = [torch.from_numpy(a).to(gpu)
              for a in (px, px.copy(), np.ones(n, bool), cx, cy)]
    short = np.setdiff1d(np.arange(n), long)
    for out in _check_k1(inputs, n, band, E, E, gpu, x_drop=3):
        ei, ej, gain, idents, alive = (t.cpu().numpy() for t in out)
        assert (alive[long] == 1).all() and (ei[long] == E).all()
        assert (gain[long] == 4 * E).all() and (idents[long] == E).all()
        assert (alive[short] == 0).all() and (gain[short] == 0).all()


@pytest.mark.parametrize("n_live", [1, 7, 9, 333, 999])
def test_kernel_n_live_not_a_multiple_of_eight(gpu, n_live):
    """Slots from a device n_live on, inside a block of 8 seeds or not,
    give zeros."""
    inputs, _ = _case(n_live, gpu)
    inputs[2] = inputs[2].clone()
    inputs[2][:n_live] = True
    right, left = _check_k1(inputs, n_live, 15, 192, 192 + 15, gpu)
    for out in (right, left):
        assert not torch.stack(out)[:, n_live:].any()
    # slot 0 sits at the start of both sequences: its right extension gains
    assert right[2][0] > 0


@pytest.mark.parametrize("band", [40, 100])
@pytest.mark.parametrize("E,extra", [(192, "band"), (512, 0)])
def test_kernel_matches_plain_wide_band(gpu, band, E, extra):
    """Band 40 runs the warp kernel at 3 cells per lane; rows wider than
    96 cells (band 100) run in the global-scratch variant of K1."""
    inputs, n_live = _case(band, gpu)
    jcap = E + band if extra == "band" else E
    for got in _check_k1(inputs, n_live, band, E, jcap, gpu):
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
