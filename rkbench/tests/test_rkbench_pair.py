"""The benchmark's pairwise path: the plain reference of a two-genome job
agrees with repkiller_tpu_torch and with its numpy oracle at tiny sizes;
a fault planted in a pairwise run's outputs, and the control, make the
pair cell incorrect; the pairwise readers read their stages and spans;
and the self-comparison path reads exactly what it read before pairs
were added. (The test imports the program; the reference does not.)"""

import hashlib
import os
import tempfile

import numpy as np
import pytest

from _tiny import SEED, run_tiny, tiny_cell
from harness import check, driver, genomes, manifest, reference, report
from test_rkbench_faults import _K, altered_score, half_seeds, unextended
from test_rkbench_program_trace import _span, recorder  # noqa: F401
from test_rkbench_reference import SETTINGS, _port_files

import control
from repkiller_tpu_torch import Config, api, device as rk_device
from repkiller_tpu_torch.chain import diagonal
from repkiller_tpu_torch.io.fasta import read_fasta
from repkiller_tpu_torch.oracle import pipeline as oracle

PAIR = "ecoli_strain_pair.banded"
FAMS = [(1024, 3, 0.02, 1), (512, 4, 0.0, 2)]
PROFILE = {"name": "strain_B", "snp_rate": 0.01, "swap": "quarter",
           "insertion_bp": 60}


def _pair(length: int, seed: int):
    a = genomes.plant(length, FAMS, seed)
    return a, genomes.derive_strain(a, PROFILE, seed + 1)


def _pair_files(tmp_path, length: int, seed: int):
    a, b = _pair(length, seed)
    px, py = os.path.join(tmp_path, "a.fa"), os.path.join(tmp_path, "b.fa")
    with open(px, "wb") as f:
        f.write(genomes.fasta_bytes([("strain_A", a)]))
    with open(py, "wb") as f:
        f.write(genomes.fasta_bytes([("strain_B", b)]))
    return px, py


def _ungapped(cell):
    """``cell`` under ungapped extension, which the CPU runs fast."""
    cell.traffic["config"]["extend_mode"] = "ungapped"
    return cell


def test_strain_b_is_a_with_the_profile():
    """Undoing the insertion and the swap leaves A with about 1% of its
    bases substituted, and nothing else changed."""
    a, b = _pair(40000, 3)
    n, q, ins = a.shape[0], a.shape[0] // 4, PROFILE["insertion_bp"]
    assert b.shape[0] == n + ins
    b = np.concatenate([b[: n // 2], b[n // 2 + ins :]])
    b = np.concatenate([b[q : 2 * q], b[:q], b[2 * q :]])
    assert 0.007 < np.mean(a != b) < 0.013 and b.max() < 4
    assert np.array_equal(genomes.derive_strain(a, PROFILE, 4),
                          genomes.derive_strain(a, PROFILE, 4))


def test_pool_writes_pairs(tmp_path):
    cell = tiny_cell(PAIR, length=20000)
    pool = genomes.make_pool(cell.config, SEED, str(tmp_path))
    assert len(pool) == cell.config["pool"]
    for i, e in enumerate(pool):
        assert e["path"].endswith(f"pair{i}_a.fa")
        assert e["path_y"].endswith(f"pair{i}_b.fa")
        x, y = driver.parse_entry(e)
        assert x.names == ["NC_000913.3"] and y.names == ["strain_B"]
        assert y.codes.shape[0] == 20000 + cell.config["strain_b"][
            "insertion_bp"]
        assert e["bp"] == x.codes.shape[0] + y.codes.shape[0]


@pytest.mark.parametrize("strands", ["f", "r", "fr"])
@pytest.mark.parametrize("mode", ["ungapped", "banded"])
def test_pair_reference_equals_program(tmp_path, mode, strands):
    """Every fragment, label and output byte of a pairwise device run, on
    a pair with a swap and an insertion, so that strand r's y mapping and
    the two spaces of the families are exercised."""
    path_x, path_y = _pair_files(tmp_path, 16000, 21)
    settings = {**SETTINGS, "extend_mode": mode, "strands": strands}
    if mode == "banded":
        settings["max_extend"] = 256
    cfg = Config(**settings)
    res = api.compare(read_fasta(path_x), read_fasta(path_y), cfg,
                      device="cpu")
    got = _port_files(res, os.path.join(tmp_path, "o"), mask=False)
    g, gy = driver.parse_entry({"path": path_x, "path_y": path_y})
    p = reference.Params.from_dict(settings)
    want, work = reference.compare(g.codes, p, codes_y=gy.codes)
    want_files = report.render(want, g, p.min_family, False, gy)
    assert res.n_fragments > 5 and work["work"] > 0
    assert set(want["strand"].tolist()) == {"fr".index(s) for s in strands}
    assert b"\nstrain_B\t" in b"\n" + want_files["repeats.bed"]
    assert check.compare([res.frag], [got], want, want_files) == {
        "fragment_rows_differing": 0, "family_labels_differing": 0,
        "file_lines_differing": 0}


@pytest.mark.parametrize("strands", ["f", "r", "fr"])
@pytest.mark.parametrize("mode", ["ungapped", "banded"])
def test_pair_reference_equals_the_numpy_oracle(mode, strands):
    a, b = _pair(12000, 5)
    b[3000:3040] = 4                          # an N run in strain B
    settings = {**SETTINGS, "extend_mode": mode, "strands": strands,
                "band": 6, "x_drop": 25, "max_extend": 256}
    want = oracle.compare(a, b, Config(**settings))
    got, _ = reference.compare(a, reference.Params.from_dict(settings),
                               codes_y=b)
    assert want["xStart"].shape[0] > 5
    assert check.rows_differing(got, want, check.TABLE + ("group",)) == 0


def test_sound_pair_run_is_correct():
    run, numbers = run_tiny(_ungapped(tiny_cell(PAIR)))
    assert run.done and check.verdict(numbers), numbers
    assert run.jobs[0].bp == 2 * 9000 + tiny_cell(PAIR).config["strain_b"][
        "insertion_bp"]


def y_shifted(merge_strands):
    """Strand r's y mapped back with a length one too long."""
    def broken(frags, valids, y_len, cfg):
        return merge_strands(frags, valids, y_len + 1, cfg)
    return broken


def one_space(cluster_families):
    """The families of a pairwise run clustered as if X and Y were one
    genome."""
    def broken(frag, cfg, self_cmp, **kw):
        return cluster_families(frag, cfg, True, **kw)
    return broken


def without_last_y_row(write_intervals):
    """The BED with its last row in space 1 (on Y's record) dropped."""
    def broken(self, dst):
        out = write_intervals(self, dst)
        with open(dst, "rb") as f:
            lines = f.read().splitlines(keepends=True)
        last = max(i for i, ln in enumerate(lines)
                   if ln.startswith(b"strain_B\t"))
        with open(dst, "wb") as f:
            f.write(b"".join(lines[:last] + lines[last + 1 :]))
        return out
    return broken


@pytest.mark.parametrize("fault,number", [
    ("y_shift", "fragment_rows_differing"),
    ("labels", "family_labels_differing"),
    ("bed_row", "file_lines_differing")])
def test_pair_fault_makes_run_incorrect(monkeypatch, fault, number):
    if fault == "y_shift":
        monkeypatch.setattr(rk_device, "merge_strands",
                            y_shifted(rk_device.merge_strands))
    elif fault == "labels":
        monkeypatch.setattr(rk_device, "cluster_families",
                            one_space(rk_device.cluster_families))
    else:
        monkeypatch.setattr(api.Result, "write_intervals",
                            without_last_y_row(api.Result.write_intervals))
    run, numbers = run_tiny(_ungapped(tiny_cell(PAIR, length=20000)))
    assert not check.verdict(numbers) and numbers[number] > 0, numbers


@pytest.mark.parametrize("fault,mode", [
    ("unchanged", "ungapped"), ("unchanged", "banded"),
    ("half", "ungapped"), ("altered", "ungapped")])
def test_timed_path_fault_makes_pair_run_incorrect(monkeypatch, fault, mode):
    """The faults the pair cell's timed path can have, as the self cells'
    fault tests plant them: a step that returns its state unchanged (each
    extension path), half of the seeds left out, one fragment's score
    altered."""
    if fault == "unchanged":
        monkeypatch.setattr(diagonal, "extend_dispatch", unextended)
        monkeypatch.setattr(diagonal, "extend_banded_gated",
                            lambda px, py, sv, anchor, cx, cy, **kw: (
                                unextended(px, py, sv, cx, cy, _K(kw)), sv))
    elif fault == "half":
        monkeypatch.setattr(rk_device, "filter_hits",
                            half_seeds(rk_device.filter_hits))
    else:
        monkeypatch.setattr(rk_device, "merge_strands",
                            altered_score(rk_device.merge_strands))
    cell = tiny_cell(PAIR, max_extend=256)
    if mode == "ungapped":
        _ungapped(cell)
    run, numbers = run_tiny(cell)
    assert not check.verdict(numbers), numbers


def test_pair_control_is_incorrect():
    cell = tiny_cell(PAIR, length=20000)
    with tempfile.TemporaryDirectory() as d:
        numbers = control.control_numbers(cell, SEED, "cpu", d)
    assert not check.verdict(numbers) and \
        numbers["fragment_rows_differing"] > 0, numbers


def _run(stages, jobs=2):
    recs = [driver.JobRecord(float(i), i + 1.0, 1000, True, 0)
            for i in range(jobs)]
    return driver.Run(manifest.cell(PAIR), 1.0, recs, 0, stages=stages)


def test_pair_stage_readers():
    stages = {"revcomp": 0.5, "index_x": 1.0, "index_y": 1.5, "join": 2.0,
              "filter": 1.0, "extend": 3.0, "merge": 1.0}
    run = _run(stages)
    assert manifest.reader("pair_index_s")(run) == pytest.approx(1.5)
    assert manifest.reader("pair_join_s")(run) == pytest.approx(1.5)
    assert manifest.reader("seeds_s")(run) is None
    self_run = _run({"seeds": 1.0, "extend": 1.0, "merge": 1.0})
    assert manifest.reader("pair_index_s")(self_run) is None
    assert manifest.reader("pair_join_s")(self_run) is None
    assert manifest.reader("pair_index_s")(_run({})) is None


def test_families_span_reads_the_window_only(recorder):  # noqa: F811
    _span(recorder, "families", 0.1, 0.6)            # the warm-up's
    _span(recorder, "families", 1.2, 1.5)
    _span(recorder, "families.propagate", 1.3, 1.4)
    _span(recorder, "families", 2.0, 2.5)
    run = _run({})
    run.jobs = [driver.JobRecord(1.0, 2.0, 1, True, 0),
                driver.JobRecord(2.0, 3.0, 1, True, 0)]
    assert manifest.reader("families_span_s")(run) == pytest.approx(0.4)
    run.jobs = [driver.JobRecord(2.55, 3.0, 1, True, 0)]
    assert manifest.reader("families_span_s")(run) is None


@pytest.mark.parametrize("name,kw,present,absent", [
    (PAIR, {}, {"pair_index_s", "pair_join_s", "families_span_s",
                "extend_s", "merge_s", "families_propagate_s",
                "csv_write_s", "bed_write_s"}, {"seeds_s"}),
    ("ecoli_k12_self.ungapped", {}, {"families_span_s", "seeds_s"},
     {"pair_index_s", "pair_join_s"}),
])
def test_traced_run_reads_the_pair_metrics(name, kw, present, absent):
    """A traced tiny run on the CPU: the pair cell reads its stages and
    the program's families span, and a self cell reads no pair stage."""
    cell = tiny_cell(name, **kw)
    if name == PAIR:
        _ungapped(cell)
    run, numbers = run_tiny(cell, trace=True)
    assert check.verdict(numbers), numbers
    listed = {e["name"] for e in cell.per_layer}
    got = manifest.read_metrics(manifest.load_manifest()["per_layer"], run)
    assert present <= set(got) and present <= listed
    assert not absent & set(got)
    assert 0 < got["families_span_s"]["value"]


# The self path as the harness read it before pairs were added: the sha256
# of a tiny pool's FASTA bytes and of the reference's table and files on
# that pool's first genome, as the parent harness gave them.
POOL_SHA = {
    ("ecoli_k12_self.banded", 9000):
        "b6fec9ab951345b1160c1e52ae8726e4941a76df3a0632c7532766233dd60ee0",
    ("dmel_2l2r_mask.banded", 8000):
        "f95b0356db6a29f570b914f9dc103dbf6f0ebf5f7ae9c81a7ee83b1fb49f0d18",
}
TABLE_SHA = {
    ("ecoli_k12_self.banded", 40000):
        ("4114f19a0483dd6b86d1e4938c194f902b62018d4f14c6748856ec6cca438648",
         88, {"work": 85487, "extended": 388}),
    ("ecoli_k12_self.ungapped", 40000):
        ("c7e551de3f47fa63b5839877564233cd771e9d1959cd5a9f23e0e053768f3afe",
         77, {"work": 67799, "extended": 388}),
    ("dmel_2l2r_mask.banded", 20000):
        ("1bbe6533a9a2cde68cfec102cba9518128c1155682e5ef575a762048610994b5",
         33, {"work": 37907, "extended": 78}),
}


@pytest.mark.parametrize("name,length", sorted(POOL_SHA))
def test_self_pool_bytes_did_not_move(tmp_path, name, length):
    cell = tiny_cell(name, length=length)
    h = hashlib.sha256()
    for e in genomes.make_pool(cell.config, SEED, str(tmp_path)):
        assert "path_y" not in e
        with open(e["path"], "rb") as f:
            h.update(f.read())
    assert h.hexdigest() == POOL_SHA[name, length]


@pytest.mark.parametrize("name,length", sorted(TABLE_SHA))
def test_self_reference_did_not_move(tmp_path, name, length):
    cell = tiny_cell(name, length=length)
    pool = genomes.make_pool(cell.config, SEED, str(tmp_path))
    g, gy = driver.parse_entry(pool[0])
    assert gy is None
    p = reference.Params.from_dict(cell.settings)
    table, work = reference.compare(g.codes, p)
    h = hashlib.sha256()
    for k in reference.FIELDS + ("group",):
        h.update(np.ascontiguousarray(table[k], np.int32).tobytes())
    files = report.render(table, g, p.min_family, cell.config["mask"])
    for k in sorted(files):
        h.update(files[k])
    assert (h.hexdigest(), table["xStart"].shape[0], work) == \
        TABLE_SHA[name, length]
