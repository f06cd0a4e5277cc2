"""The port's own copies of the host-only modules against the JAX package's:
``config``, ``oracle.pipeline``, ``table``, ``io.fasta``, ``report``
writers, ``families.cluster``, ``utils.{synth,capacity}`` and the CLI's
parser. Integer outputs and written files: exact equality, byte for byte.
Also the port's layering: only ``api`` imports the oracle, for
``backend="oracle"``; and the names the benchmark harness patches exist
where it patches them."""

import ast
import dataclasses
import importlib
import io
from pathlib import Path

import numpy as np
import pytest

from repkiller_tpu import cli as jcli
from repkiller_tpu.config import Config as JConfig
from repkiller_tpu.families import cluster as jcluster
from repkiller_tpu.io import fasta as jfasta
from repkiller_tpu.oracle import pipeline as jorc
from repkiller_tpu.report import csv_writer as jcsv, intervals as jiv
from repkiller_tpu.utils import capacity as jcap, synth as jsynth
import repkiller_tpu_torch
from repkiller_tpu_torch import cli as tcli, table
from repkiller_tpu_torch.config import Config
from repkiller_tpu_torch.families import cluster as tcluster
from repkiller_tpu_torch.io import fasta as tfasta
from repkiller_tpu_torch.oracle import pipeline as torc
from repkiller_tpu_torch.report import csv_writer as tcsv, intervals as tiv
from repkiller_tpu_torch.utils import capacity as tcap, synth as tsynth

FAMS = [(400, 3, 0.03, 1), (150, 4, 0.0, 1), (80, 3, 0.06, 0)]


def _ref(cfg: Config) -> JConfig:
    return JConfig(**dataclasses.asdict(cfg))


def _assert_dict_equal(got, want):
    assert got.keys() == want.keys()
    for f in want:
        assert np.array_equal(got[f], want[f]), f


def test_config_fields_and_defaults():
    got = [(f.name, f.type, f.default) for f in dataclasses.fields(Config)]
    want = [(f.name, f.type, f.default) for f in dataclasses.fields(JConfig)]
    assert got == want
    assert dataclasses.asdict(Config()) == dataclasses.asdict(JConfig())
    assert Config().seed_cap == JConfig().seed_cap
    cfg = Config().replace(band=8, seed_capacity=64)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        JConfig().replace(band=8, seed_capacity=64))


@pytest.mark.parametrize("bad", [
    dict(k=17), dict(gate_stride=-1), dict(min_hit_dist=0), dict(window=0),
    dict(extend_mode="x"), dict(banded_impl="x"), dict(ungapped_impl="x"),
    dict(strands="q"), dict(gap_open=-1), dict(shard_slack=0.5),
    dict(seed_capacity=-1), dict(seed_capacity=1 << 21),
])
def test_config_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError) as want:
        JConfig(**bad)
    with pytest.raises(ValueError) as got:
        Config(**bad)
    assert str(got.value) == str(want.value)


def _genome(seed, L=6000):
    return tsynth.plant(L, FAMS, seed=seed).codes


def _pair(seed):
    x = _genome(seed)
    y = x[700:5200].copy()
    y[::89] = (y[::89] + 1) % 4
    return x, y


@pytest.mark.parametrize("mode", ["ungapped", "banded"])
@pytest.mark.parametrize("pair", [False, True], ids=["self", "pair"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_oracle_compare_matches_reference(seed, pair, mode):
    x, y = _pair(seed)
    y = y if pair else None
    cfg = Config(k=12, strands="fr", extend_mode=mode, band=8,
                 hit_capacity=1 << 13, max_extend=256)
    got = torc.compare(x, y, cfg)
    want = jorc.compare(x, y, _ref(cfg))
    _assert_dict_equal(got, want)
    assert got["xStart"].shape[0] > 0


def test_synth_matches_reference():
    got = tsynth.plant(9000, FAMS, seed=11)
    want = jsynth.plant(9000, FAMS, seed=11)
    assert np.array_equal(got.codes, want.codes)
    assert [dataclasses.asdict(r) for r in got.repeats] == \
        [dataclasses.asdict(r) for r in want.repeats]


@pytest.fixture(scope="module", params=[False, True], ids=["self", "cross"])
def frags(request):
    """Fragments of the reference oracle, canonical order, with their
    family labels dropped: (frag, cfg, self_cmp, x SeqSet, y SeqSet)."""
    x, y = _pair(5)
    cross = request.param
    cfg = Config(k=12, strands="fr", hit_capacity=1 << 13, max_extend=256)
    frag = jorc.compare(x, y if cross else None, _ref(cfg))
    frag.pop("group")
    xs = jfasta.from_codes(x, "chrX")
    ys = jfasta.from_codes(y, "chrY") if cross else None
    return frag, cfg, not cross, xs, ys


def test_cluster_families_matches_reference(frags):
    frag, cfg, self_cmp, _, _ = frags
    got = tcluster.cluster_families(frag, cfg, self_cmp)
    want = jcluster.cluster_families(frag, _ref(cfg), self_cmp)
    assert np.array_equal(got, want)
    assert np.unique(got).shape[0] < got.shape[0]
    small = tcluster.cluster_families(frag, cfg, self_cmp, edge_chunk=7)
    assert np.array_equal(small, want)


def _labelled(frags):
    frag, cfg, self_cmp, xs, ys = frags
    frag = dict(frag, group=jcluster.cluster_families(frag, _ref(cfg), self_cmp))
    return frag, cfg, self_cmp, xs, ys


def test_csv_writer_matches_reference(frags, tmp_path):
    """Same bytes to a text stream and to a path (where the reference may
    take its native writer), and the same dict read back."""
    frag, cfg, self_cmp, xs, ys = _labelled(frags)
    kw = dict(x_name="chrX", y_name=None if self_cmp else "chrY",
              x_len=xs.total_length,
              y_len=(xs if self_cmp else ys).total_length, total_hits=1234)
    got, want = io.StringIO(), io.StringIO()
    tcsv.write_frags_csv(frag, got, **kw)
    jcsv.write_frags_csv(frag, want, **kw)
    assert got.getvalue() == want.getvalue()
    tcsv.write_frags_csv(frag, str(tmp_path / "t.csv"), **kw)
    jcsv.write_frags_csv(frag, str(tmp_path / "j.csv"), **kw)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    back = tcsv.read_frags_csv(got.getvalue())
    _assert_dict_equal(back, jcsv.read_frags_csv(want.getvalue()))


def test_intervals_bed_and_family_summary_match_reference(frags):
    frag, cfg, self_cmp, xs, ys = _labelled(frags)
    kw = dict(x_name="chrX", y_name="chrX" if self_cmp else "chrY",
              x_seqs=xs, y_seqs=xs if self_cmp else ys)
    got, want = io.StringIO(), io.StringIO()
    iv_got = tiv.write_intervals_bed(frag, cfg, got, self_cmp, **kw)
    iv_want = jiv.write_intervals_bed(frag, _ref(cfg), want, self_cmp, **kw)
    assert got.getvalue() == want.getvalue() and got.getvalue()
    assert iv_got.keys() == iv_want.keys()
    for space in iv_want:
        assert np.array_equal(iv_got[space], iv_want[space])
    got, want = io.StringIO(), io.StringIO()
    tiv.write_family_summary(frag, got)
    jiv.write_family_summary(frag, want)
    assert got.getvalue() == want.getvalue() and got.getvalue()


def test_table_matches_reference_oracle(frags):
    """``table``'s canonical order, family statistics, repeat intervals and
    interval union against the JAX package's oracle on the same table."""
    frag, cfg, self_cmp, _, _ = _labelled(frags)
    shuffled = {f: v[np.random.default_rng(3).permutation(v.shape[0])]
                for f, v in frag.items()}
    _assert_dict_equal(table.canonical_sort(shuffled),
                       jorc.canonical_sort(shuffled))
    _assert_dict_equal(table.family_stats(frag, frag["group"]),
                       jorc.family_stats(frag, frag["group"]))
    got = table.repeat_intervals(frag, frag["group"], cfg, self_cmp)
    want = jorc.repeat_intervals(frag, frag["group"], _ref(cfg), self_cmp)
    _assert_dict_equal(got, want)
    # one family of every fragment: each space's union of all intervals
    space, start, end, _ = table.intervals_of(frag, self_cmp)
    o = np.lexsort((end, start))
    s, e = start[o][space[o] == 0], end[o][space[o] == 0]
    everything = jorc.repeat_intervals(
        frag, np.zeros(frag["xStart"].shape[0], np.int32), _ref(cfg), self_cmp)
    assert np.array_equal(table.union_intervals(s, e), everything[0])
    assert everything[0].shape[0] < s.shape[0]


PORT = Path(repkiller_tpu_torch.__file__).parent


def _oracle_imports(tree: ast.AST) -> list:
    """Line numbers of the imports of the oracle package in a module."""
    lines = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] + [a.name for a in node.names]
        else:
            continue
        if any("oracle" in m.split(".") for m in mods):
            lines.append(node.lineno)
    return lines


def test_only_api_imports_the_oracle():
    """Outside ``oracle/`` one module imports the oracle, ``api``, once,
    and uses nothing of it but ``compare`` (``backend="oracle"``)."""
    found = {}
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT)
        if rel.parts[0] == "oracle":
            continue
        lines = _oracle_imports(ast.parse(path.read_text()))
        if lines:
            found[str(rel)] = lines
    assert list(found) == ["api.py"] and len(found["api.py"]) == 1, found
    tree = ast.parse((PORT / "api.py").read_text())
    used = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
            and isinstance(n.value, ast.Name) and n.value.id == "orc"}
    assert used == {"compare"}


@pytest.mark.parametrize("module, name", [
    ("device", "cluster_families"), ("device", "filter_hits"),
    ("device", "merge_strands"), ("dist.sharded", "cluster_families"),
    ("dist.sharded", "filter_hits"), ("dist.sharded", "merge_strands"),
    ("chain.diagonal", "extend_dispatch"),
    ("chain.diagonal", "extend_banded_gated"),
    ("api", "Result.write_csv"), ("api", "Result.write_intervals"),
    ("api", "Result.write_family_summary"),
    ("dist.mesh", "ProcessMesh.all_to_all"), ("utils.trace", "spans"),
    ("utils.trace", "dropped")])
def test_harness_patched_names_exist(module, name):
    """The benchmark harness and its tests patch these module attributes;
    each must stay where they patch it."""
    obj = importlib.import_module("repkiller_tpu_torch." + module)
    for part in name.split("."):
        obj = getattr(obj, part)
    assert callable(obj)


MULTI_FASTA = (b">chr1 first record\nACGTNNNNacgtRYKM\nACGTACGTAC\n\n"
               b">chr2\nNNNNNNNNNN\nGGGCCCAAATTT\n>\nacgtn\n")


@pytest.mark.parametrize("source", ["bytes", "path", "text", "stream"])
def test_fasta_read_matches_reference(tmp_path, source):
    """A multi-record FASTA with Ns, lower case, IUPAC codes, an empty line
    and a nameless header: the same codes, names, offsets and lengths."""
    path = tmp_path / "m.fa"
    path.write_bytes(MULTI_FASTA)
    src = {"bytes": lambda: MULTI_FASTA, "path": lambda: str(path),
           "text": lambda: MULTI_FASTA.decode(),
           "stream": lambda: io.BytesIO(MULTI_FASTA)}[source]
    got, want = tfasta.read_fasta(src()), jfasta.read_fasta(src())
    assert np.array_equal(got.codes, want.codes)
    assert got.names == want.names == ["chr1", "chr2", "seq2"]
    assert np.array_equal(got.offsets, want.offsets)
    assert np.array_equal(got.lengths, want.lengths)
    assert (got.codes == 4).any()


@pytest.mark.parametrize("msg", [
    "hit_capacity=64 overflow: strand hit totals [99]",
    "seed_capacity=16 overflow: strand seed counts [40]",
    "frag capacity overflow (9 fragments fill the array)",
    "shard_slack too small", "something else"])
def test_grow_capacity_matches_reference(msg):
    cfg = Config(hit_capacity=64, seed_capacity=16)
    got = tcap.grow_capacity(cfg, msg)
    want = jcap.grow_capacity(_ref(cfg), msg)
    if want is None:
        assert got is None
    else:
        assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
        assert got[1] == want[1]


@pytest.mark.parametrize("cmd", ["run", "group"])
def test_cli_parser_has_the_reference_flags(cmd):
    """The port's parser takes every flag of the reference's, with the same
    defaults, plus ``run --device``."""
    def flags(parser):
        sub = next(a for a in parser._actions if a.dest == "cmd")
        return {a.dest: (a.option_strings, a.default)
                for a in sub.choices[cmd]._actions if a.dest != "help"}
    got, want = flags(tcli.build_parser()), flags(jcli.build_parser())
    extra = {"device": (["--device"], "cuda")} if cmd == "run" else {}
    assert got == {**want, **extra}
