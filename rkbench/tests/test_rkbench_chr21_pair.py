"""The chromosome-pair cell ``human_chr21_pair.banded1`` in miniature: its
configuration derives the second chromosome as declared, a tiny run of
the cell through the sharded pairwise branch on the CPU is correct under
``banded1``, the control is not, and the readers of the sharded stage-A
spans read what the window holds and None without it. (The test imports
the program; the reference does not.)"""

import tempfile

import pytest

from _tiny import SEED, run_tiny, tiny_cell
from harness import check, genomes, manifest, report
from test_rkbench_program_trace import _run, _span, recorder  # noqa: F401

import control

CELL = "human_chr21_pair.banded1"
READERS = {"sharded_index_s": ("sharded.index",),
           "sharded_join_s": ("sharded.hits",)}


def test_the_cell_as_declared():
    cell = manifest.cell(CELL)
    cfg = cell.config
    assert cell.chips == 1 and cfg["comparison"] == "pair"
    assert cfg["backend"] == "sharded" and cfg["mesh"] == {"n_data": 1,
                                                           "n_shard": 1}
    (rec,) = cfg["records"]
    b = cfg["strain_b"]
    assert rec["length"] + rec["length"] + b["insertion_bp"] == 93425966
    assert cell.traffic["check_genomes"] == 1
    assert cell.settings["extend_mode"] == "banded"
    listed = {e["name"] for e in cell.per_layer}
    assert set(READERS) | {"k1_roofline", "sharded_seeds_s"} <= listed
    assert not {"seeds_s", "pair_index_s", "pair_join_s",
                "sharded_regroup_s"} & listed


def test_pool_pairs_have_the_profile(tmp_path):
    cell = tiny_cell(CELL, length=20000)
    ins = cell.config["strain_b"]["insertion_bp"]
    for e in genomes.make_pool(cell.config, SEED, str(tmp_path)):
        x, y = (report.parse_fasta((tmp_path / e[k]).read_bytes())
                for k in ("path", "path_y"))
        assert x.names == ["chr21"] and y.names == ["chr21_b"]
        assert y.codes.shape[0] == 20000 + ins
        assert e["bp"] == 2 * 20000 + ins


def test_tiny_cell_is_correct():
    run, numbers = run_tiny(tiny_cell(CELL, length=12000, max_extend=256))
    assert run.done and check.verdict(numbers), numbers
    assert numbers["failed_jobs"] == 0


def test_tiny_control_is_incorrect():
    cell = tiny_cell(CELL, length=20000, max_extend=2048)
    with tempfile.TemporaryDirectory() as d:
        numbers = control.control_numbers(cell, SEED, "cpu", d)
    assert not check.verdict(numbers) and \
        numbers["fragment_rows_differing"] > 0, numbers


@pytest.mark.parametrize("metric,names", sorted(READERS.items()))
def test_readers_read_the_window_device_time(recorder, metric,  # noqa: F811
                                             names):
    read = manifest.reader(metric)
    run = _run([(10.0, 11.0), (11.0, 13.0)])
    assert read(run) is None                     # no such span
    for name in names:
        _span(recorder, name, 0.0, 1.0)          # the warm-up's
        _span(recorder, name, 10.5, 10.75)
        _span(recorder, name, 12.0, 12.5)
    assert read(run) is None                     # no device time yet
    for r in recorder._ring:
        r.device_s = 0.25
    assert read(run) == pytest.approx(0.25)      # two spans over two jobs
    other = "sharded.hits" if names == ("sharded.index",) else "sharded.index"
    _span(recorder, other, 12.6, 12.7)
    recorder._ring[-1].device_s = 4.0
    assert read(run) == pytest.approx(0.25)
