"""Tests of the torch port that need an NVIDIA GPU: kernels K1 and K2
against their plain versions on the card, the pipeline on the card
(self and pairwise, banded and ungapped; single-shot, staged with resume,
streamed, sharded on a one-process mesh and on a one-rank NCCL process
mesh, and per-stage timing) against the CPU or device.compare, and the
device path of family clustering on the card against the host path.

They skip where no GPU is visible; on a machine with one, run
    python -m pytest tests/test_torch_cuda.py -q
This file imports no JAX and nothing of the JAX package, so it also runs
where JAX is not installed. Integer outputs: exact equality."""

import numpy as np
import pytest
import torch

from repkiller_tpu_torch import device as tdevice
from repkiller_tpu_torch.config import Config
from repkiller_tpu_torch.dist.mesh import ProcessMesh, make_mesh
from repkiller_tpu_torch.dist.sharded import compare_sharded
from repkiller_tpu_torch.dist.windows import compare_streamed
from repkiller_tpu_torch.extend import _cuda, ungapped
from repkiller_tpu_torch.extend.banded import direction_plain
from repkiller_tpu_torch.families import cluster as tcluster
from repkiller_tpu_torch.oracle import pipeline as torc
from repkiller_tpu_torch.table import canonical_sort
from repkiller_tpu_torch.utils import synth, trace
from repkiller_tpu_torch.utils.metrics import profile_stages

pytestmark = pytest.mark.cuda


def launches(mode: str) -> int:
    """K1's (banded) or K2's (ungapped) launches so far, from the trace."""
    return trace.totals().get(
        "k1_launches" if mode == "banded" else "k2_launches", 0)


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


def ungapped_boundary_case(step, k, match, mismatch, run, E=128):
    """Seeds on the identity diagonal whose extension in direction ``step``
    (+1 from px + k, -1 from px - 1) ends at chosen steps -> (px, py,
    valid, cx, cy, n_live) as numpy arrays. ``run`` mismatches in a row
    stop a seed whose x_drop is run * -mismatch at the run's last step:
    - stops by x-drop at steps 31, 32, 33, 63 and 64, one of them with an N
      in x (valid, never a match), and by leaving the sequence at the same
      steps (those seeds sit at the sequence's ends);
    - a best tied across the chunk boundary (at steps 30 and 31 against
      steps after 31; the earlier one must win), then only mismatches;
    - seeds that run to E; an invalid seed; slots from n_live on.
    ``-mismatch`` must be a multiple of ``match`` (for the ties)."""
    assert -mismatch % match == 0
    back = -mismatch // match  # matches that undo one mismatch
    rng = np.random.default_rng(run * 7 + back)
    span, margin = E + 2 * run + 8, 128
    plans = []  # per seed: the steps that mismatch, and which of them is N
    for t in (31, 32, 33, 63, 64):
        plans.append((range(t - run + 1, t + 1), t - run + 1 if t == 33 else -1))
    for g1 in (30, 31):  # best at g1, one mismatch, `back` matches: a tie
        plans.append(([g1 + 1] + list(range(g1 + 2 + back, E)), -1))
    plans += [((), -1), ((), -1)]
    L = 2 * margin + span * len(plans)
    cx = rng.integers(0, 4, L, dtype=np.uint8)
    cy = cx.copy()
    pos0 = []  # position of step 0 of each seed
    for i, (mis, n_at) in enumerate(plans):
        p0 = margin + i * span + (4 if step > 0 else span - 4)
        pos0.append(p0)
        for g in mis:
            q = p0 + step * g
            cy[q] = (cx[q] + 1) % 4
            if g == n_at:
                cx[q] = 4
    for t in (31, 32, 33, 63, 64):  # step t is the first outside the sequence
        pos0.append(L - t if step > 0 else t - 1)
    base_off = k if step > 0 else -1
    px = np.array(pos0, np.int64) - base_off
    px = np.concatenate([px, px[:3]]).astype(np.int32)  # 3 slots past n_live
    valid = np.ones(px.shape[0], bool)
    n_live = px.shape[0] - 3
    valid[n_live:] = False
    valid[len(plans) - 1] = False
    return px, px.copy(), valid, cx, cy, n_live


def ungapped_long_seeds_case(step, k, E=2048, n=32):
    """n seeds on the identity diagonal, 5 of which run to E in direction
    ``step`` while each of the others meets one mismatch after 1-40 steps
    (at x_drop 4 and scores 4/-4 it stops there) -> (px, py, valid, cx,
    cy, the long seeds' slots) as numpy arrays."""
    rng = np.random.default_rng(5 + step)
    span = E + 64
    cx = rng.integers(0, 4, n * span, dtype=np.uint8)
    cy = cx.copy()
    long = rng.choice(n, 5, replace=False)
    pos0 = np.arange(n) * span + (16 if step > 0 else span - 16)
    for i in np.setdiff1d(np.arange(n), long):
        q = pos0[i] + step * int(rng.integers(1, 41))
        cy[q] = (cx[q] + 1) % 4
    px = (pos0 - (k if step > 0 else -1)).astype(np.int32)
    return px, px.copy(), np.ones(n, bool), cx, cy, long


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
        before = launches("banded")
        got = _cuda.banded_gotoh(*inputs, *args, torch.tensor(n_live, device=gpu))
        assert launches("banded") == before + 1
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


@pytest.mark.parametrize("band", [15, 47, 48])
def test_kernel_takes_scores_past_its_keys(gpu, band):
    """Scores whose values could leave the warp kernel's packed keys (bands
    15 and 47) run in the wide kernel, as rows wider than 96 cells (band
    48) do: exact, launched, and nothing raises."""
    inputs, n_live = _case(1, gpu)
    _check_k1(inputs, n_live, band, 192, 192 + band, gpu,
              scores=(8000, -8000, 1000, 500))


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
        before = launches("ungapped")
        got = _cuda.ungapped_xdrop(*inputs, *args,
                                   torch.tensor(n_live, device=gpu))
        assert launches("ungapped") == before + 1
        want = ungapped.direction_plain(*inputs, *args, n_live)
        for name, g, w in zip(("ext", "gain", "idents"), got, want):
            assert torch.equal(g, w), (E, x_drop, step, name)
        assert (got[0] > 0).any()


def _check_k2(inputs, n_live, args, gpu):
    """K2 against the plain version, exactly, with a device n_live -> the
    kernel's outputs."""
    before = launches("ungapped")
    got = _cuda.ungapped_xdrop(*inputs, *args, torch.tensor(n_live, device=gpu))
    assert launches("ungapped") == before + 1
    want = ungapped.direction_plain(*inputs, *args, n_live)
    for name, g, w in zip(("ext", "gain", "idents"), got, want):
        assert torch.equal(g, w), (args, name)
    return got


@pytest.mark.parametrize("match,mismatch,x_drop", [
    (4, -4, 20), (1000, -3000, 15000), (4, -4, 2**31 - 1),
    (1000, -3000, 2**31 - 1)])
@pytest.mark.parametrize("step", [+1, -1])
def test_ungapped_kernel_chunk_boundaries(gpu, match, mismatch, x_drop, step):
    """Stops at steps 31-33 and 63-64, a best tied across the hand-off from
    a lane to the warp at step 32, seeds that run to E, extreme scores and
    the drop switched off (tests/test_torch_ungapped.py holds the plain
    version against the JAX package on the same cases)."""
    px, py, valid, cx, cy, n_live = ungapped_boundary_case(
        step, 12, match, mismatch, 5)
    inputs = [torch.from_numpy(a).to(gpu) for a in (px, py, valid, cx, cy)]
    args = (12 if step > 0 else -1, step, match, mismatch, x_drop, 128)
    got = _check_k2(inputs, n_live, args, gpu)
    assert got[0][7] == 128 and list(got[0][9:14].tolist()) == [31, 32, 33, 63, 64]


@pytest.mark.parametrize("step", [+1, -1])
def test_ungapped_kernel_long_seeds_in_one_warp(gpu, step):
    """One warp's 32 slots: 5 seeds run to E = 2048 among seeds that stop
    after 1-40 steps."""
    *case, long = ungapped_long_seeds_case(step, 12)
    inputs = [torch.from_numpy(a).to(gpu) for a in case]
    base_off = 12 if step > 0 else -1
    got = _check_k2(inputs, 32, (base_off, step, 4, -4, 4, 2048), gpu)
    ext = got[0].cpu().numpy()
    short = np.setdiff1d(np.arange(32), long)
    assert (ext[long] == 2048).all()
    assert (ext[short] >= 1).all() and (ext[short] <= 40).all()


@pytest.mark.parametrize("n_live", [0, 1, 31, 32, 33])
def test_ungapped_kernel_device_n_live(gpu, n_live):
    """n = 524,288 slots, every one valid, with a device n_live: the live
    slots match the plain version and every slot from n_live on reads
    zero, though the output's memory held other values just before."""
    n, L = 524288, 200000
    rng = np.random.default_rng(n_live)
    cx = rng.integers(0, 4, L, dtype=np.uint8)
    cy = cx.copy()
    mut = rng.random(L) < 0.05
    cy[mut] = (cy[mut] + 1) % 4
    px = rng.integers(0, L - 12, n).astype(np.int32)
    inputs = [torch.from_numpy(a).to(gpu)
              for a in (px, px.copy(), np.ones(n, bool), cx, cy)]
    for base_off, step in ((12, +1), (-1, -1)):
        # leave other values in the memory the caching allocator hands out
        del_me = torch.full((3, n), -7, dtype=torch.int32, device=gpu)
        del del_me
        got = _check_k2(inputs, n_live, (base_off, step, 4, -4, 40, 2048), gpu)
        assert not torch.stack(got)[:, n_live:].any()
        if n_live:
            assert (got[0][:n_live] > 0).any()


def test_pipeline_on_card_matches_cpu(gpu):
    g = synth.plant(20000, [(400, 3, 0.03, 1), (150, 4, 0.0, 1)], seed=2)
    cfg = Config(k=12, strands="fr", extend_mode="banded",
                 hit_capacity=1 << 14, max_extend=512)
    before = launches("banded")
    got = tdevice.compare(g.codes, None, cfg, gpu)
    assert launches("banded") > before
    want = tdevice.compare(g.codes, None, cfg, "cpu")
    assert got["xStart"].shape[0] > 0
    for f in want:
        assert np.array_equal(got[f], want[f]), f


def test_ungapped_pipeline_on_card_matches_cpu(gpu):
    """The default Config (ungapped) with both strands, self-comparison."""
    g = synth.plant(20000, [(400, 3, 0.03, 1), (150, 4, 0.0, 1)], seed=3)
    cfg = Config(strands="fr", hit_capacity=1 << 14)
    k1, k2 = launches("banded"), launches("ungapped")
    got = tdevice.compare(g.codes, None, cfg, gpu)
    assert launches("ungapped") > k2
    assert launches("banded") == k1
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
    before = launches(mode)
    got = tdevice.compare(g.codes, y, cfg, gpu)
    assert launches(mode) > before
    want = tdevice.compare(g.codes, y, cfg, "cpu")
    assert got["xStart"].shape[0] > 0 and (got["strand"] == 1).any()
    for f in want:
        assert np.array_equal(got[f], want[f]), f




@pytest.mark.parametrize("mode", ["ungapped", "banded"])
@pytest.mark.parametrize("pair", [False, True], ids=["self", "pair"])
def test_streamed_on_card_matches_cpu(gpu, tmp_path, mode, pair):
    """compare_streamed on the card launches its mode's kernel in every
    window and equals the CPU; a resume from its out_dir launches none."""
    g = synth.plant(20000, [(400, 3, 0.03, 1), (150, 4, 0.0, 1)], seed=5)
    y = None
    if pair:
        y = g.codes[2000:18000].copy()
        y[::41] = (y[::41] + 1) % 4
    cfg = Config(k=12, strands="fr", extend_mode=mode, hit_capacity=1 << 14,
                 max_extend=512, gate_stride=256)
    other = "banded" if mode == "ungapped" else "ungapped"
    k, o = launches(mode), launches(other)
    stats = {}
    got = compare_streamed(g.codes, y, cfg, out_dir=str(tmp_path),
                           window=4096, device=gpu, stats=stats)
    assert launches(mode) - k >= 2 * stats["windows"] == 10
    assert launches(other) == o
    want = compare_streamed(g.codes, y, cfg, window=4096, device="cpu")
    assert got["xStart"].shape[0] > 0 and (got["strand"] == 1).any()
    for f in want:
        assert np.array_equal(got[f], want[f]), f
    k = launches(mode)
    again = compare_streamed(g.codes, y, cfg, out_dir=str(tmp_path),
                             window=4096, device=gpu)
    assert launches(mode) == k
    for f in want:
        assert np.array_equal(again[f], want[f]), f


@pytest.mark.parametrize("mode", ["ungapped", "banded"])
@pytest.mark.parametrize("pair", [False, True], ids=["self", "pair"])
def test_staged_on_card_matches_cpu(gpu, tmp_path, mode, pair):
    """Staged with keep_intermediates on the card equals the CPU's
    output without a store; the resume runs no kernel and no heavy stage."""
    g = synth.plant(20000, [(400, 3, 0.03, 1), (150, 4, 0.0, 1)], seed=6)
    y = g.codes[1000:15000].copy() if pair else None
    cfg = Config(k=12, strands="fr", extend_mode=mode, hit_capacity=1 << 15,
                 max_extend=512)
    k = launches(mode)
    got = tdevice.compare(g.codes, y, cfg, gpu,
                          keep_intermediates=str(tmp_path))
    assert launches(mode) > k
    want = tdevice.compare(g.codes, y, cfg, "cpu")
    assert got["xStart"].shape[0] > 0
    k, timings = launches(mode), {}
    again = tdevice.compare(g.codes, y, cfg, gpu, timings=timings,
                            keep_intermediates=str(tmp_path))
    assert launches(mode) == k
    assert "extend" not in timings and "seeds" not in timings \
        and "join" not in timings, timings
    for f in want:
        assert np.array_equal(got[f], want[f]), f
        assert np.array_equal(again[f], want[f]), f


def test_profile_stages_on_card_matches_cpu(gpu):
    g = synth.plant(20000, [(400, 3, 0.03, 1), (150, 4, 0.0, 1)], seed=7)
    cfg = Config(k=12, strands="fr", hit_capacity=1 << 14)
    got = profile_stages(g.codes, None, cfg, device=gpu)
    want = profile_stages(g.codes, None, cfg, device="cpu")
    for r in got + want:
        assert r.pop("wall_s") >= 0
    assert got == want and got[2]["hits"] > 0


@pytest.mark.parametrize("mode", ["ungapped", "banded"])
@pytest.mark.parametrize("pair", [False, True], ids=["self", "pair"])
def test_sharded_mesh_on_card_matches_device(gpu, mode, pair):
    """A (2, 2) one-process mesh of four bodies on the card equals
    device.compare on the card, and launches the mode's kernel."""
    g = synth.plant(20000, [(400, 3, 0.03, 1), (150, 4, 0.0, 1)], seed=8)
    y = g.codes[1000:15000].copy() if pair else None
    cfg = Config(k=12, strands="fr", extend_mode=mode, hit_capacity=1 << 15,
                 max_extend=512)
    want = tdevice.compare(g.codes, y, cfg, gpu)
    k = launches(mode)
    got = compare_sharded(g.codes, y, cfg, make_mesh(2, 2, [gpu] * 4))
    assert launches(mode) > k
    assert got["xStart"].shape[0] > 0
    for f in want:
        assert np.array_equal(got[f], want[f]), f


def test_sharded_nccl_process_mesh_matches_local_mesh(gpu):
    """A one-rank NCCL process group: compare_sharded over its process mesh
    (its collectives run on the card) equals the one-process mesh."""
    import socket
    import torch.distributed as dist

    g = synth.plant(20000, [(400, 3, 0.03, 1), (150, 4, 0.0, 1)], seed=9)
    cfg = Config(k=12, strands="fr", extend_mode="banded",
                 hit_capacity=1 << 15, max_extend=512)
    want = compare_sharded(g.codes, None, cfg, make_mesh(devices=[gpu]))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        assert isinstance(mesh, ProcessMesh) and mesh.devices[(0, 0)] == gpu
        got = compare_sharded(g.codes, None, cfg, mesh)
    finally:
        dist.destroy_process_group()
    for f in want:
        assert np.array_equal(got[f], want[f]), f


def random_frags(n, seed, L=20000):
    """tests/unit/test_families.py's random fragment table."""
    rng = np.random.default_rng(seed)
    ln = rng.integers(40, 400, n).astype(np.int32)
    xs = rng.integers(0, L, n).astype(np.int32)
    ys = rng.integers(0, L, n).astype(np.int32)
    frag = {
        "xStart": xs, "yStart": ys,
        "xEnd": (xs + ln - 1).astype(np.int32),
        "yEnd": (ys + ln - 1).astype(np.int32),
        "strand": rng.integers(0, 2, n).astype(np.int32),
        "length": ln,
        "score": rng.integers(0, 2000, n).astype(np.int32),
        "idents": (ln * 0.9).astype(np.int32),
    }
    return canonical_sort(frag)


def pileup_frags():
    """tests/unit/test_families.py's 600-fragment pileup: chain components
    split by the ratio filter (clustered with proximity 50)."""
    rng = np.random.default_rng(12)
    n = 600
    xs = np.sort(rng.integers(0, 3000, n)).astype(np.int32)
    ln = np.where(np.arange(n) % 3 == 0, 80, 400).astype(np.int32)
    frag = {
        "xStart": xs, "yStart": xs + 7,
        "xEnd": (xs + ln - 1).astype(np.int32),
        "yEnd": (xs + 6 + ln).astype(np.int32),
        "strand": np.zeros(n, np.int32),
        "length": ln,
        "score": np.full(n, 100, np.int32),
        "idents": np.full(n, 90, np.int32),
    }
    return canonical_sort(frag)


CLUSTER_CONFIGS = [Config(), Config(proximity=100, len_ratio=0.0),
                   Config(proximity=5, len_ratio=0.9),
                   Config(proximity=5, len_ratio=0.97)]


@pytest.mark.parametrize("seed,n,self_cmp", [
    (7, 300, True), (8, 800, False), (9, 0, True), (10, 5000, True),
])
def test_device_clustering_on_card_matches_host(gpu, seed, n, self_cmp):
    frag = random_frags(n, seed)
    for cfg in CLUSTER_CONFIGS:
        host = tcluster.cluster_families(frag, cfg, self_cmp, device="cpu")
        got = tcluster.cluster_families(frag, cfg, self_cmp,
                                        device_min_fragments=0, device=gpu)
        assert got.dtype == np.int32 and np.array_equal(got, host)


def test_device_clustering_on_card_dense_pileup(gpu):
    frag, cfg = pileup_frags(), Config(proximity=50)
    got = tcluster.cluster_families(frag, cfg, True, device_min_fragments=0,
                                    device=gpu)
    assert np.array_equal(got, torc.cluster_families(frag, cfg, True))


def _spy_device_path(monkeypatch) -> list:
    """Records the device of each call of the device path, then runs it."""
    calls = []
    device_path = tcluster.cluster_families_device

    def spy(frag, cfg, self_cmp, device, *args):
        calls.append(torch.device(device).type)
        return device_path(frag, cfg, self_cmp, device, *args)

    monkeypatch.setattr(tcluster, "cluster_families_device", spy)
    return calls


@pytest.mark.parametrize("seed,n,self_cmp", [
    (11, 5000, True), (12, 5000, False), (13, 20000, True),
])
def test_default_rule_clusters_on_the_card(gpu, monkeypatch, seed, n,
                                           self_cmp):
    """On the card the default rule sends a table of DEVICE_MIN_FRAGMENTS
    fragments or more to the device path, and a smaller one to the host
    path; the labels equal the host path's either way."""
    calls = _spy_device_path(monkeypatch)
    frag = random_frags(n, seed, L=80 * n)
    small = {f: v[:tcluster.DEVICE_MIN_FRAGMENTS - 1] for f, v in frag.items()}
    for cfg in CLUSTER_CONFIGS:
        for table in (frag, small):
            host = tcluster.cluster_families(table, cfg, self_cmp,
                                             device="cpu")
            got = tcluster.cluster_families(table, cfg, self_cmp, device=gpu)
            assert got.dtype == np.int32 and np.array_equal(got, host)
    big = n >= tcluster.DEVICE_MIN_FRAGMENTS
    assert calls == ["cuda"] * len(CLUSTER_CONFIGS) * big


def test_chr1_sized_table_clusters_on_the_card_in_blocks(gpu, monkeypatch):
    """A synthetic table of 2.25M fragments at chr1's density (its
    fragments over 249 Mbp) takes the device path by default, in several
    edge blocks, and gives the host path's labels."""
    calls = _spy_device_path(monkeypatch)
    frag, cfg = random_frags(2_250_000, 14, L=248_956_422), Config()
    *_, total, _ = tcluster._edge_ranges(frag, cfg, True)
    with trace.job() as job_id:
        got = tcluster.cluster_families(frag, cfg, True, device=gpu)
    host = tcluster.cluster_families(frag, cfg, True, device="cpu")
    assert calls == ["cuda"] and np.array_equal(got, host)
    counts = next(s["counters"] for s in trace.spans()
                  if s["job"] == job_id and s["name"] == "families.propagate")
    assert counts["path"] == 1
    assert counts["blocks"] == -(-total // tcluster.EDGE_CHUNK) > 1
