"""The benchmark's plain reference agrees with repkiller_tpu_torch at tiny
sizes on the CPU: fragment tables, family labels, every output file, and
the parse of the FASTA the harness writes. (The test imports both; the
reference imports nothing of the program.)"""

import os

import numpy as np
import pytest

import _tiny  # noqa: F401  (puts the harness on sys.path)
from harness import check, genomes, reference, report

from repkiller_tpu_torch import Config, api
from repkiller_tpu_torch.dist.mesh import make_mesh
from repkiller_tpu_torch.io.fasta import read_fasta
from repkiller_tpu_torch.oracle import pipeline as oracle
from repkiller_tpu_torch.utils import synth

FAMS = [(900, 4, 0.02, 2), (512, 4, 0.0, 1), (300, 6, 0.08, 2)]
SETTINGS = dict(k=12, max_occ=64, min_hit_dist=32, gate_stride=2048,
                match=4, mismatch=-4, x_drop=40, max_extend=2048, band=15,
                gap_open=8, gap_extend=2, min_len=40, min_identity=0.6,
                proximity=32, len_ratio=0.5, min_family=2, strands="fr",
                hit_capacity=1 << 16, seed_capacity=1 << 15)


def _genome(tmp_path, lengths, seed, n_block=False):
    recs = []
    for i, ln in enumerate(lengths):
        codes = genomes.plant(ln, FAMS, seed + i)
        if n_block:                      # an N run inside the record
            codes[ln // 3 : ln // 3 + 50] = 4
        recs.append((f"chr{i}", codes))
    path = os.path.join(tmp_path, "g.fa")
    with open(path, "wb") as f:
        f.write(genomes.fasta_bytes(recs))
    return path


def _port_files(res, prefix, mask):
    res.write_csv(prefix + ".frags.csv")
    res.write_family_summary(prefix + ".families.csv")
    res.write_intervals(prefix + ".repeats.bed")
    names = ["frags.csv", "families.csv", "repeats.bed"]
    if mask:
        with open(prefix + ".masked.fasta", "w") as f:
            f.write(res.masked_fasta())
        names.append("masked.fasta")
    out = {}
    for n in names:
        with open(f"{prefix}.{n}", "rb") as f:
            out[n] = f.read()
    return out


def test_plant_is_the_programs():
    for seed in (0, 2**31 + 9):
        assert np.array_equal(genomes.plant(30000, FAMS, seed),
                              synth.plant(30000, FAMS, seed=seed).codes)


@pytest.mark.parametrize("lengths,n_block", [([30000], False),
                                             ([17000, 13000], True)])
def test_parse_is_the_programs(tmp_path, lengths, n_block):
    path = _genome(tmp_path, lengths, 5, n_block)
    with open(path, "rb") as f:
        g = report.parse_fasta(f.read())
    s = read_fasta(path)
    assert np.array_equal(g.codes, s.codes) and g.names == s.names
    assert np.array_equal(g.offsets, s.offsets)
    assert np.array_equal(g.lengths, s.lengths)


@pytest.mark.parametrize("mode", ["ungapped", "banded"])
@pytest.mark.parametrize("lengths,n_block,backend", [
    ([12000], False, "device"), ([7000, 6000], True, "device"),
    ([7000, 6000], True, "sharded")])
def test_reference_equals_program(tmp_path, mode, lengths, n_block, backend):
    path = _genome(tmp_path, lengths, 17, n_block)
    cfg = Config(**SETTINGS, extend_mode=mode)
    mesh = make_mesh(1, 1, devices=["cpu"]) if backend == "sharded" else None
    res = api.compare(read_fasta(path), None, cfg, backend=backend,
                      device="cpu", mesh=mesh)
    got = _port_files(res, os.path.join(tmp_path, "o"), mask=True)
    with open(path, "rb") as f:
        g = report.parse_fasta(f.read())
    p = reference.Params.from_dict({**SETTINGS, "extend_mode": mode})
    want, work = reference.compare(g.codes, p)
    want_files = report.render(want, g, p.min_family, mask=True)
    assert res.n_fragments > 20 and work["work"] > 0
    numbers = check.compare([res.frag], [got], want, want_files)
    assert numbers == {"fragment_rows_differing": 0,
                       "family_labels_differing": 0,
                       "file_lines_differing": 0}


@pytest.mark.parametrize("mode", ["ungapped", "banded"])
def test_reference_equals_the_numpy_oracle(mode):
    codes = genomes.plant(12000, FAMS, 3)
    codes[4000:4040] = 4
    settings = {**SETTINGS, "extend_mode": mode, "band": 6, "x_drop": 25,
                "max_extend": 256}
    want = oracle.compare(codes, None, Config(**settings))
    got, _ = reference.compare(codes, reference.Params.from_dict(settings))
    assert want["xStart"].shape[0] > 10
    assert check.rows_differing(got, want, check.TABLE + ("group",)) == 0


def test_work_counts_rows_and_steps_once():
    """The ungapped work is every step each extended seed examines, up to
    and including its stop, each direction once: here against a scalar
    loop over every thinned seed (gating off)."""
    codes = genomes.plant(6000, FAMS[:1], 8)
    p = reference.Params.from_dict({**SETTINGS, "extend_mode": "ungapped",
                                    "strands": "f", "gate_stride": 0})
    _, w = reference.compare(codes, p)
    # with gating off every thinned seed extends, both directions
    import torch
    cx = torch.from_numpy(codes)
    km, pos = reference.kmer_index(cx, p.k)
    px, py = reference.thin(*reference.self_hits_f(km, pos, p.max_occ), p,
                            codes.shape[0])
    assert w["extended"] == 2 * px.numel()
    steps = 0
    for i in range(px.numel()):
        for x0, y0, step in ((int(px[i]) + p.k, int(py[i]) + p.k, 1),
                             (int(px[i]) - 1, int(py[i]) - 1, -1)):
            s, rm, t = 0, 0, 0
            while t < p.max_extend:
                x, y = x0 + step * t, y0 + step * t
                t += 1
                if not (0 <= x < codes.shape[0] and 0 <= y < codes.shape[0]):
                    break
                eq = codes[x] == codes[y] and codes[x] < 4
                s += p.match if eq else p.mismatch
                rm = max(rm, s)
                if s <= rm - p.x_drop:
                    break
            steps += t
    assert w["work"] == steps


def test_merge_ties_take_the_total_order():
    """Two fragments equal in (score, length, xStart, yStart) from seeds on
    two diagonals: the winner is the smaller (xEnd, yEnd, idents), as the
    program's merge orders every field, not the first in seed order."""
    import torch
    p = reference.Params.from_dict({**SETTINGS, "extend_mode": "banded"})
    t = lambda *v: torch.tensor(v, dtype=torch.int64)
    frag = {"xStart": t(100, 100), "yStart": t(300, 300), "xEnd": t(145, 145),
            "yEnd": t(332, 332), "strand": t(0, 0), "length": t(46, 46),
            "score": t(66, 66), "idents": t(31, 30)}
    out = reference.merge_accept(frag, p, 10_000)
    assert out["idents"].tolist() == [30]
