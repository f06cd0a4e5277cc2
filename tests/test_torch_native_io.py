"""The port's native host I/O (io/native.py over csrc/repkiller_io.cpp)
against the JAX package's native library and against the port's own
numpy and Python paths: FASTA parsing, 2-bit packing, reverse complement
and the fragment CSV writer, byte for byte; and how the library is built
(a broken source raises, no g++ leaves the numpy paths)."""

import io
import os
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


def _tie_table():
    """Every (idents, length) with length up to 160, exact ties of the
    similarity's last digit among them ((1, 32) -> 3.125), the ties the
    double cannot hold exactly ((1, 20000) -> 0.005), length 0, and
    identities beyond the length."""
    pairs = [(i, ln) for ln in range(1, 161) for i in range(ln + 1)]
    pairs += [(1, 32), (3, 800), (1, 800), (1, 20000), (7, 20000), (0, 0),
              (9, 0), (1, 2**31 - 1), (2**31 - 1, 2**31 - 1),
              (12345, 2**31 - 1), (2**31 - 1, 1), (10**6, 3), (104857, 1000)]
    idn, ln = (np.array(v, np.int32) for v in zip(*pairs))
    n = idn.shape[0]
    frag = _random_table(7, n)
    frag["idents"], frag["length"] = idn, ln
    return frag


def _edge_table(seed, n=4000):
    """Coordinates near 2^31 - 1, the int32 ends in the other columns,
    negative identities and lengths, and length 0."""
    rng = np.random.default_rng(seed)
    top = 2**31 - 2
    frag = {f: rng.integers(top - 5000, top, n, endpoint=True).astype(np.int32)
            for f in ("xStart", "yStart", "xEnd", "yEnd")}
    frag["xEnd"][:4] = top
    frag["strand"] = rng.integers(0, 2, n).astype(np.int32)
    for f in ("length", "score", "idents", "group"):
        frag[f] = rng.integers(-2**31, 2**31, n).astype(np.int32)
    frag["length"][: n // 2] = rng.integers(-3000, 3000, n // 2)
    frag["idents"][: n // 2] = rng.integers(-3000, 3000, n // 2)
    frag["length"][::7] = 0
    frag["score"][:2] = (-2**31, 2**31 - 1)
    return frag


def _records(seed, lengths, spacer=31):
    """A multi-record SeqSet (records of ``lengths`` with ``spacer`` N
    codes between them)."""
    offs = np.concatenate([[0], np.cumsum(np.add(lengths, spacer))[:-1]])
    codes = np.zeros(int(offs[-1] + lengths[-1]), np.uint8)
    return tfasta.SeqSet(codes=codes, names=[f"r{seed}_{i}" for i in
                                             range(len(lengths))],
                         offsets=offs.astype(np.int64),
                         lengths=np.asarray(lengths, np.int64))


def _record_table(seed, xs, ys, n=3000):
    """Fragments each inside one record of ``xs`` and one of ``ys``."""
    rng = np.random.default_rng(seed)
    ln = rng.integers(1, 300, n).astype(np.int64)

    def starts(seqs):
        r = rng.integers(0, len(seqs.names), n)
        return seqs.offsets[r] + rng.integers(0, seqs.lengths[r] - ln)

    x0, y0 = starts(xs), starts(ys)
    strand = rng.integers(0, 2, n)
    frag = {"xStart": x0, "xEnd": x0 + ln - 1,
            "yStart": np.where(strand == 0, y0, y0 + ln - 1),
            "yEnd": np.where(strand == 0, y0 + ln - 1, y0),
            "strand": strand, "length": ln,
            "score": rng.integers(-100, 4000, n),
            "idents": (ln * rng.uniform(0.5, 1.0, n)).astype(np.int64),
            "group": rng.integers(0, 40, n)}
    return torc.canonical_sort({f: v.astype(np.int32)
                                for f, v in frag.items()})


def _python_rows(frag, dst, monkeypatch, **kw):
    """The CSV writer's Python rows: the writer without its library."""
    with monkeypatch.context() as m:
        m.setattr(tnative, "available", lambda: False)
        tcsv.write_frags_csv(frag, dst, **kw)


def _written(write, tmp_path, name):
    """(bytes of ``write`` to a path, bytes of ``write`` to a stream)."""
    path = str(tmp_path / name)
    write(path)
    buf = io.StringIO()
    write(buf)
    return open(path, "rb").read(), buf.getvalue().encode()


@pytest.mark.parametrize("n,group", [(0, True), (1, True), (200, True),
                                     (5000, True), (300, False),
                                     ("ties", True), ("edges", True),
                                     (200_000, True)])
@pytest.mark.parametrize("self_cmp", [True, False])
def test_write_frags_csv_matches_reference_and_python(n, group, self_cmp,
                                                      tmp_path, monkeypatch):
    """The native writer to a path and to a stream, the Python rows and
    the JAX package's writer (to a path and to a stream) give the same
    bytes; the table of 200,000 rows is formatted on several threads."""
    frag = {"ties": _tie_table, "edges": lambda: _edge_table(11)}.get(
        n, lambda: _random_table(n + 5, n, group))()
    n = int(frag["xStart"].shape[0])
    kw = dict(x_name="gx", x_len=10000, total_hits=777)
    if not self_cmp:
        kw.update(y_name="gy", y_len=9000)
    got, streamed = _written(lambda d: tcsv.write_frags_csv(frag, d, **kw),
                             tmp_path, "native.csv")
    python = io.StringIO()
    _python_rows(frag, python, monkeypatch, **kw)
    ref, ref_streamed = _written(lambda d: jcsv.write_frags_csv(frag, d, **kw),
                                 tmp_path, "ref.csv")
    assert got.count(b"\nFrag,") == n
    assert got == streamed == python.getvalue().encode()
    assert got == ref == ref_streamed
    header = tcsv._render_header(n, kw["x_name"], kw.get("y_name"),
                                 kw["x_len"], kw.get("y_len", 0), 777)
    direct = str(tmp_path / "direct.csv")
    threads = tnative.write_frags_csv(direct, header, frag, self_cmp)
    assert open(direct, "rb").read() == got
    assert 1 <= threads <= 8
    if n < 8192 or (os.cpu_count() or 1) == 1:
        assert threads == 1
    else:
        assert threads > 1


@pytest.mark.parametrize("records", [2, 3])
@pytest.mark.parametrize("self_cmp", [True, False])
def test_write_frags_csv_multirecord_matches_reference_and_python(
        records, self_cmp, tmp_path, monkeypatch):
    """Multi-record tables (per-row record ids, and record-local
    coordinates under coords="record") through the native writer, to a
    path and to a stream, against the Python rows and the JAX package's
    writer; read_frags_csv gives the table back. A cross comparison pairs
    two records of X with one of Y (the seqY=1 convention), or three
    with two."""
    xs = _records(records, [5000, 700, 2600][:records])
    ys = xs if self_cmp else _records(records + 10, [4000, 1800][:records - 1])
    frag = _record_table(records, xs, ys)
    for coords in ("concat", "record"):
        kw = dict(x_name="gx", x_len=xs.total_length, total_hits=5,
                  x_seqs=xs, coords=coords)
        if not self_cmp:
            kw.update(y_name="gy", y_len=ys.total_length, y_seqs=ys)
        got, streamed = _written(
            lambda d: tcsv.write_frags_csv(frag, d, **kw), tmp_path, "t.csv")
        python = io.StringIO()
        _python_rows(frag, python, monkeypatch, **kw)
        ref, ref_streamed = _written(
            lambda d: jcsv.write_frags_csv(frag, d, **kw), tmp_path, "j.csv")
        assert got == streamed == python.getvalue().encode()
        assert got == ref == ref_streamed
        rows = [line.split(b",") for line in got.splitlines()
                if line.startswith(b"Frag,")]
        assert {int(r[12]) for r in rows} == set(range(records))
        assert {int(r[13]) for r in rows} == (
            set(range(len(ys.names))) if len(ys.names) > 1 else {1})
        back = tcsv.read_frags_csv(got.decode())
        for f in ("xStart", "yStart", "xEnd", "yEnd", "strand", "length",
                  "score", "idents", "group"):
            assert np.array_equal(back[f], frag[f]), (coords, f)


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
