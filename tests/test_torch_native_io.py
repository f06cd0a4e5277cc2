"""The port's native host I/O (io/native.py over csrc/repkiller_io.cpp)
against the JAX package's native library and against the port's own
numpy and Python paths: FASTA parsing, 2-bit packing, reverse complement
and the fragment CSV writer, byte for byte; and how the library is built
(a broken source raises, no g++ leaves the numpy paths)."""

import io
import shutil

import numpy as np
import pytest

from repkiller_tpu.io import fasta as jfasta, native as jnative
from repkiller_tpu.report import csv_writer as jcsv
from repkiller_tpu_torch.io import codec as tcodec, fasta as tfasta
from repkiller_tpu_torch.io import native as tnative
from repkiller_tpu_torch.oracle import pipeline as torc
from repkiller_tpu_torch.report import csv_writer as tcsv

from _torch_threads import one_torch_thread  # noqa: F401

FASTA_CASES = [
    b">a desc\nACGTacgtNNXX\nGG\n>b\n\nTTTT\n",
    b"ACGT\nTTTT",                      # headerless implicit seq0
    b">only_header_no_seq\n>second\nAC\n",
    b">crlf\r\nACGT\r\nTT\r\n>mac\rGGGG\r",
    b"",
    b"\n\n  \n",
    b">spaces\n  AC GT  \n",            # inner space maps to N, ends stripped
]


@pytest.fixture(autouse=True)
def native_lib():
    """Both packages' native libraries, built here; skips without g++."""
    if shutil.which("g++") is None:
        pytest.skip("native I/O library needs g++")
    assert tnative.available() and jnative.available()


def _wrapped_fasta(seed, records=3, n=5000, width=61):
    rng = np.random.default_rng(seed)
    out = []
    for r in range(records):
        seq = np.frombuffer(b"ACGTNacgtn", np.uint8)[
            rng.integers(0, 10, n + 97 * r)].tobytes()
        out.append(b">rec%d some description\n" % r)
        out += [seq[i:i + width] + b"\n" for i in range(0, len(seq), width)]
    return b"".join(out)


def _seqsets_equal(got, want):
    assert got.names == want.names and got.path == want.path
    for f in ("codes", "offsets", "lengths"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f


@pytest.mark.parametrize("spacer", [1, 32])
@pytest.mark.parametrize("i", range(len(FASTA_CASES) + 1))
def test_parse_fasta_matches_reference_and_numpy(i, spacer):
    data = FASTA_CASES[i] if i < len(FASTA_CASES) else _wrapped_fasta(i)
    got = tnative.parse_fasta(data, spacer)
    want = jnative.parse_fasta(data, spacer)
    numpy_path = tfasta.parse_numpy(data, spacer)
    for g, w, p in zip(got, want, (numpy_path.codes, numpy_path.offsets,
                                   numpy_path.lengths)):
        assert g.dtype == w.dtype == p.dtype
        assert np.array_equal(g, w) and np.array_equal(g, p)
    _seqsets_equal(tfasta.read_fasta(data, spacer=spacer), numpy_path)


@pytest.mark.parametrize("source", ["path", "bytes", "file"])
def test_read_fasta_matches_reference(source, tmp_path):
    data = _wrapped_fasta(3)
    path = tmp_path / "x.fa"
    path.write_bytes(data)

    def src():
        return {"path": str(path), "bytes": data,
                "file": io.BytesIO(data)}[source]

    got = tfasta.read_fasta(src())
    _seqsets_equal(got, jfasta.read_fasta(src()))
    _seqsets_equal(got, tfasta.parse_numpy(data, path=got.path))


def test_pack_2bit_matches_reference_and_codec():
    rng = np.random.default_rng(3)
    for n in (0, 1, 15, 16, 17, 31, 32, 1000, 100003, 1 << 21):
        codes = rng.integers(0, 5, n, dtype=np.uint8)
        got = tnative.pack_2bit(codes)
        for want in (jnative.pack_2bit(codes), tcodec.pack_2bit(codes)):
            assert got[2] == want[2]
            assert np.array_equal(got[0], want[0])
            assert np.array_equal(got[1], want[1])


def test_revcomp_matches_reference_and_codec():
    rng = np.random.default_rng(4)
    for n in (0, 1, 999):
        codes = rng.integers(0, 5, n, dtype=np.uint8)
        got = tnative.revcomp(codes)
        assert np.array_equal(got, jnative.revcomp(codes))
        assert np.array_equal(got, tcodec.revcomp_codes(codes))


def _random_table(seed, n, group=True):
    rng = np.random.default_rng(seed)
    ln = rng.integers(30, 400, n).astype(np.int32)
    frag = {
        "xStart": rng.integers(0, 10000, n).astype(np.int32),
        "yStart": rng.integers(0, 10000, n).astype(np.int32),
        "strand": rng.integers(0, 2, n).astype(np.int32),
        "length": ln,
        "score": rng.integers(-100, 4000, n).astype(np.int32),
        "idents": (ln * rng.uniform(0.5, 1.0, n)).astype(np.int32),
    }
    frag["xEnd"] = frag["xStart"] + ln - 1
    frag["yEnd"] = np.where(frag["strand"] == 0, frag["yStart"] + ln - 1,
                            frag["yStart"] - ln + 1).astype(np.int32)
    if n:
        frag["idents"][0] = 0
        frag["length"][0] = 0            # the similarity's division guard
    frag = torc.canonical_sort(frag)
    if group:
        frag["group"] = rng.integers(0, 40, n).astype(np.int32)
    return frag


@pytest.mark.parametrize("n,group", [(0, True), (1, True), (200, True),
                                     (5000, True), (300, False)])
@pytest.mark.parametrize("self_cmp", [True, False])
def test_write_frags_csv_matches_reference_and_python(n, group, self_cmp,
                                                      tmp_path):
    frag = _random_table(n + 5, n, group)
    kw = dict(x_name="gx", x_len=10000, total_hits=777)
    if not self_cmp:
        kw.update(y_name="gy", y_len=9000)
    native_path = str(tmp_path / "native.csv")
    tcsv.write_frags_csv(frag, native_path, **kw)        # the native writer
    buf = io.StringIO()
    tcsv.write_frags_csv(frag, buf, **kw)                # the Python writer
    ref_path = str(tmp_path / "ref.csv")
    jcsv.write_frags_csv(frag, ref_path, **kw)
    got = open(native_path, "rb").read()
    assert got == buf.getvalue().encode()
    assert got == open(ref_path, "rb").read()
    header = tcsv._render_header(n, kw["x_name"], kw.get("y_name"),
                                 kw["x_len"], kw.get("y_len", 0), 777)
    direct = str(tmp_path / "direct.csv")
    assert tnative.write_frags_csv(direct, header, frag, self_cmp) == n
    assert open(direct, "rb").read() == got


def test_write_frags_csv_rejects_short_columns(tmp_path):
    frag = _random_table(1, 10)
    frag["score"] = frag["score"][:9]
    with pytest.raises(ValueError, match="score"):
        tnative.write_frags_csv(str(tmp_path / "x.csv"), "", frag, True)


def test_broken_source_raises(tmp_path, monkeypatch):
    """A build failure with g++ present raises with the compiler's message
    (the reference returns no library and keeps the numpy paths)."""
    broken = tmp_path / "repkiller_io.cpp"
    broken.write_text(tnative.SOURCE.read_text() + "\nint broken(\n")
    monkeypatch.setattr(tnative, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tfasta.read_fasta(FASTA_CASES[0])
    assert not tnative.library_path(broken).exists()


def test_without_gxx_the_numpy_paths_run(tmp_path, monkeypatch):
    """No g++ and no build: available() is false, read_fasta and the CSV
    writer give the same results through their numpy and Python paths,
    and the native entry points raise."""
    unbuilt = tmp_path / "repkiller_io.cpp"
    unbuilt.write_text(tnative.SOURCE.read_text() + "\n// unbuilt copy\n")
    monkeypatch.setattr(tnative, "SOURCE", unbuilt)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert not tnative.available()
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        tnative.parse_fasta(FASTA_CASES[0])
    data = _wrapped_fasta(5)
    _seqsets_equal(tfasta.read_fasta(data), jfasta.read_fasta(data))
    frag = _random_table(6, 100)
    tcsv.write_frags_csv(frag, str(tmp_path / "py.csv"), x_len=10000)
    jcsv.write_frags_csv(frag, str(tmp_path / "ref.csv"), x_len=10000)
    assert (tmp_path / "py.csv").read_bytes() == \
        (tmp_path / "ref.csv").read_bytes()
