"""The correctness check of a run sees each fault the timed path can have:
the harness drives whole jobs on the CPU with the program broken
underneath, and ``correct`` comes out false. A sound run and the control
come out as they should."""

import tempfile

import pytest
import torch

from _tiny import SEED, run_tiny, tiny_cell
from harness import check

import control
from repkiller_tpu_torch import api, device as rk_device
from repkiller_tpu_torch.chain import diagonal
from repkiller_tpu_torch.dist import sharded

CELLS = {"device": ("ecoli_k12_self.ungapped", {}),
         "sharded": ("dmel_2l2r_mask.banded", {"length": 8000})}


def _cell(path: str):
    name, kw = CELLS[path]
    return tiny_cell(name, **kw)


def unextended(spx, spy, svalid, cx, cy, cfg, n_live=None):
    """A step that returns its state unchanged: every seed comes back as
    its own k-mer, unextended."""
    z = torch.zeros_like(spx)
    frag = {"xStart": spx, "yStart": spy, "xEnd": spx + cfg.k - 1,
            "yEnd": spy + cfg.k - 1, "strand": z,
            "score": z + cfg.k * cfg.match, "idents": z + cfg.k,
            "length": z + cfg.k}
    return {f: torch.where(svalid, v, 0) for f, v in frag.items()}


def half_seeds(filter_hits):
    """Half of the batch left out: the second half of the thinned seeds, in
    their (diagonal, px) order, dropped."""
    def broken(*args, **kwargs):
        px, py, valid, n = filter_hits(*args, **kwargs)
        keep = torch.arange(valid.shape[0], device=valid.device) < n // 2
        return px, py, valid & keep, n
    return broken


def altered_score(merge_strands):
    """An answer altered where it is produced: one fragment's score."""
    def broken(*args, **kwargs):
        out, valid, n = merge_strands(*args, **kwargs)
        first = torch.nonzero(valid)[:1, 0]
        out["score"] = out["score"].clone()
        out["score"][first] += 1
        return out, valid, n
    return broken


def test_sound_runs_are_correct():
    for path in CELLS:
        run, numbers = run_tiny(_cell(path))
        assert run.done and check.verdict(numbers), (path, numbers)
        assert numbers["fragment_rows_differing"] == 0


@pytest.mark.parametrize("path", sorted(CELLS))
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "file"])
def test_fault_makes_run_incorrect(monkeypatch, path, fault):
    if fault == "unchanged":
        monkeypatch.setattr(diagonal, "extend_dispatch", unextended)
        monkeypatch.setattr(diagonal, "extend_banded_gated",
                            lambda px, py, sv, anchor, cx, cy, **kw: (
                                unextended(px, py, sv, cx, cy, _K(kw)), sv))
    elif fault == "half":
        monkeypatch.setattr(rk_device, "filter_hits",
                            half_seeds(rk_device.filter_hits))
        monkeypatch.setattr(sharded, "filter_hits",
                            half_seeds(sharded.filter_hits))
    elif fault == "altered":
        monkeypatch.setattr(rk_device, "merge_strands",
                            altered_score(rk_device.merge_strands))
        monkeypatch.setattr(sharded, "merge_strands",
                            altered_score(sharded.merge_strands))
    else:
        write = api.Result.write_family_summary

        def one_byte_off(self, dst):
            out = write(self, dst)
            with open(dst, "r+b") as f:
                f.seek(7)
                f.write(b"X")
            return out
        monkeypatch.setattr(api.Result, "write_family_summary", one_byte_off)
    run, numbers = run_tiny(_cell(path))
    assert not check.verdict(numbers), (path, fault, numbers)


class _K:
    """The scoring a fused banded call passes, as a Config-like object."""

    def __init__(self, kw):
        self.k, self.match = kw["k"], kw["match"]


def test_control_is_incorrect():
    for name in ("ecoli_k12_self.banded", "ecoli_k12_self.ungapped"):
        cell = tiny_cell(name, length=12000)
        with tempfile.TemporaryDirectory() as d:
            numbers = control.control_numbers(cell, SEED, "cpu", d)
        assert not check.verdict(numbers), (name, numbers)
        assert numbers["fragment_rows_differing"] > 0


def test_traced_run_reads_its_layers():
    """A traced run on the CPU: spans of every layer, the program's stage
    walls, and a trace of whole jobs whose idle time is labelled by the
    spans open on the host (no device here, so no kernel and no
    roofline)."""
    from harness import manifest
    cell = _cell("device")
    run, numbers = run_tiny(cell, trace=True)
    assert check.verdict(numbers)
    got = manifest.read_metrics(cell.per_layer, run)
    assert {"fasta_read_s", "seeds_s", "extend_s", "merge_s", "families_s",
            "write_s"} <= set(got)
    assert "k2_roofline" not in got
    assert run.trace.window_s > 0
    assert {"families", "write", "fasta_read"} <= set(run.trace.idle_by_span)
