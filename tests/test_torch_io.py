"""The port's file I/O (cogaps_tpu_torch/io) against the JAX package's
(cogaps_tpu/io), on the CPU.

* the native parser (io/native.py, built from native/fastparse.cpp into
  cogaps_tpu_torch/_build/) and the pure-Python parsers each read
  data/GIST.{csv,tsv,gct,mtx} exactly as cogaps_tpu's read_matrix does
  with and without its native parser: equal float32 matrices, equal
  names (tests/test_io.py:17-30 is the JAX contract);
* both parsers dequote names and read gct headers as the JAX package
  does; read_mtx_coo, file_info and write_csv equal the JAX functions;
* the native build is keyed by a hash of its source and falls back to
  the Python parsers, saying so once, when it cannot be built, and for
  the file, naming it, when it fails on one file;
* io/rdata.py reads a gzip'd XDR RDS stream and RData workspace built
  here exactly as cogaps_tpu/io/rdata.py does."""

import dataclasses
import gzip
import os
import struct

import numpy as np
import pytest

from cogaps_tpu.io import parsers as jparsers
from cogaps_tpu.io import rdata as jrdata
from cogaps_tpu_torch.io import native, parsers, rdata

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
GIST = ["csv", "tsv", "gct", "mtx"]


def _same(mine, theirs):
    np.testing.assert_array_equal(mine[0], theirs[0])
    assert mine[0].dtype == theirs[0].dtype == np.float32
    assert mine[1] == theirs[1] and mine[2] == theirs[2]


@pytest.mark.parametrize("ext", GIST)
def test_native_parser_matches_jax(ext):
    assert native.available(), native.failure()
    path = os.path.join(DATA, f"GIST.{ext}")
    mine = parsers.read_matrix(path)
    _same(mine, jparsers.read_matrix(path, use_native=True))
    # the Python parsers read the same bits
    _same(mine, jparsers.read_matrix(path, use_native=False))
    assert mine[0].shape == (1363, 9)


@pytest.mark.parametrize("ext", GIST)
def test_python_parser_matches_jax(ext):
    path = os.path.join(DATA, f"GIST.{ext}")
    _same(parsers.read_matrix(path, use_native=False),
          jparsers.read_matrix(path, use_native=False))


def test_native_build_lands_in_build_dir():
    assert native.available()
    lib = native.library_path()
    assert lib.parent == native.BUILD_DIR and lib.exists()
    assert lib.parent.name == "_build" and lib.parent.parent.name == \
        "cogaps_tpu_torch"
    assert native.SOURCE == native.BUILD_DIR.parent.parent / "native" / \
        "fastparse.cpp"


def test_native_build_is_keyed_by_its_source(tmp_path, monkeypatch):
    src = tmp_path / "fastparse.cpp"
    src.write_bytes(native.SOURCE.read_bytes())
    first = native.library_path()
    try:
        native.library_path.cache_clear()
        monkeypatch.setattr(native, "SOURCE", src)
        assert native.library_path() == first
        native.library_path.cache_clear()
        src.write_bytes(native.SOURCE.read_bytes() + b"\n// changed\n")
        assert native.library_path() != first
    finally:
        native.library_path.cache_clear()


def test_fallback_to_python_is_said_once(monkeypatch, capsys):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failure", "RuntimeError: no compiler")
    monkeypatch.setattr(parsers, "_fell_back", False)
    assert not native.available()
    path = os.path.join(DATA, "GIST.csv")
    for _ in range(2):
        _same(parsers.read_matrix(path),
              jparsers.read_matrix(path, use_native=False))
    err = capsys.readouterr().err
    assert err.count("native parser is unavailable") == 1
    assert "no compiler" in err


def test_native_failure_on_a_file_is_said_for_that_file(monkeypatch, capsys):
    assert native.available(), native.failure()

    def refuse(path, sep, gct=False):
        raise ValueError(f"bad row in {os.path.basename(path)}")

    monkeypatch.setattr(native, "read_delim", refuse)
    monkeypatch.setattr(parsers, "_fell_back", False)
    paths = [os.path.join(DATA, f"GIST.{ext}") for ext in ("csv", "tsv")]
    for path in paths + paths:
        _same(parsers.read_matrix(path),
              jparsers.read_matrix(path, use_native=False))
    err = capsys.readouterr().err
    for path in paths:
        assert err.count(f"the native parser failed on {path} (ValueError: "
                         f"bad row in {os.path.basename(path)})") == 2
    assert "unavailable" not in err and not parsers._fell_back
    assert native.available()


@pytest.mark.parametrize("sep,ext", [(",", "csv"), ("\t", "tsv")])
def test_dequoting_matches_jax(tmp_path, sep, ext):
    path = str(tmp_path / f"q.{ext}")
    rows = ['"g1"', "'g2'", " g3 ", '"g,4"' if sep == "\t" else "g4"]
    with open(path, "w") as f:
        f.write(sep.join(["", '"s1"', "'s2'", "s3"]) + "\n")
        for i, r in enumerate(rows):
            f.write(sep.join([r, f"{i}.5", "1e-3", f"{i + 7}"]) + "\n")
    mine_n = parsers.read_matrix(path)
    mine_p = parsers.read_matrix(path, use_native=False)
    _same(mine_n, jparsers.read_matrix(path, use_native=True))
    _same(mine_p, jparsers.read_matrix(path, use_native=False))
    _same(mine_n, mine_p)
    assert mine_n[1][:3] == ["g1", "g2", "g3"]
    assert mine_n[2] == ["s1", "s2", "s3"]


def test_gct_header_matches_jax(tmp_path):
    path = str(tmp_path / "h.gct")
    with open(path, "w") as f:
        f.write("#1.2\n3\t2\nName\tDescription\t\"c1\"\tc2\n")
        for i in range(3):
            f.write(f"'r{i}'\tna\t{i}.25\t{2 * i}\n")
    mine = parsers.read_matrix(path)
    _same(mine, jparsers.read_matrix(path, use_native=True))
    _same(parsers.read_matrix(path, use_native=False),
          jparsers.read_matrix(path, use_native=False))
    assert mine[1] == ["r0", "r1", "r2"] and mine[2] == ["c1", "c2"]


def test_read_mtx_coo_matches_jax(tmp_path):
    path = str(tmp_path / "m.mtx")
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n% note\n")
        f.write("3 4 3\n1 1 5.0\n3 4 2.5\n2 2\n")
    mine = parsers.read_mtx_coo(path)
    theirs = jparsers.read_mtx_coo(path)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    assert mine[0].tolist() == [0, 2, 1] and mine[4] == 4
    # the native reader gives the same triplets
    for a, b in zip(native.read_mtx_coo(path), mine):
        np.testing.assert_array_equal(a, b)
    full = os.path.join(DATA, "GIST.mtx")
    for a, b in zip(parsers.read_mtx_coo(full), jparsers.read_mtx_coo(full)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ext", GIST)
def test_file_info_matches_jax(ext):
    path = os.path.join(DATA, f"GIST.{ext}")
    mine, theirs = parsers.file_info(path), jparsers.file_info(path)
    assert mine == theirs
    assert (mine["nRows"], mine["nCols"]) == (1363, 9)


def test_write_csv_round_trip_matches_jax(tmp_path):
    rs = np.random.default_rng(3)
    D = rs.gamma(2.0, 1.5, (25, 20)).astype(np.float32)
    genes = [f"g{i}" for i in range(25)]
    samples = [f"s{j}" for j in range(20)]
    mine, theirs = str(tmp_path / "mine.csv"), str(tmp_path / "theirs.csv")
    parsers.write_csv(mine, D, genes, samples)
    jparsers.write_csv(theirs, D, genes, samples)
    assert open(mine).read() == open(theirs).read()
    for use_native in (True, False):
        mat, rn, cn = parsers.read_matrix(mine, use_native=use_native)
        np.testing.assert_array_equal(mat, D)  # %.10g holds a float32
        assert rn == genes and cn == samples
    default = str(tmp_path / "default.csv")
    parsers.write_csv(default, D[:3, :2])
    assert parsers.read_matrix(default)[1:] == (
        ["Gene_1", "Gene_2", "Gene_3"], ["Sample_1", "Sample_2"])


# ----------------------------------------------------------------------
# io/rdata.py: an XDR serialization stream built here
# ----------------------------------------------------------------------
def _i(v):
    return struct.pack(">i", v)


def _charsxp(s):
    b = s.encode()
    return _i(9) + _i(len(b)) + b


class _Writer:
    """Just enough of R's XDR serialization for the reader's SEXP types:
    symbols (written once, then as references), pairlists, vectors with
    attributes, lists and S4 objects."""

    def __init__(self):
        self.syms = []

    def sym(self, name):
        if name in self.syms:
            return _i(((self.syms.index(name) + 1) << 8) | 255)
        self.syms.append(name)
        return _i(1) + _charsxp(name)

    def pairlist(self, items):
        out = b""
        for tag, value in items:
            out += _i(2 | 0x400) + self.sym(tag) + value
        return out + _i(254)

    def vec(self, typ, n, body, attrs=None):
        flags = typ | (0x200 if attrs else 0)
        return _i(flags) + _i(n) + body + (self.pairlist(attrs)
                                           if attrs else b"")

    def real(self, x, attrs=None):
        x = np.asarray(x, ">f8").ravel(order="F")
        return self.vec(14, x.size, x.tobytes(), attrs)

    def ints(self, x, attrs=None):
        x = np.asarray(x, ">i4")
        return self.vec(13, x.size, x.tobytes(), attrs)

    def lgl(self, x):
        return self.vec(10, len(x), np.asarray(x, ">i4").tobytes())

    def strs(self, xs, attrs=None):
        return self.vec(16, len(xs), b"".join(_charsxp(s) for s in xs),
                        attrs)

    def vlist(self, items, attrs=None):
        return self.vec(19, len(items), b"".join(items), attrs)

    def s4(self, cls, slots):
        return _i(25 | 0x200) + self.pairlist(
            slots + [("class", self.strs([cls]))])


def _objects(w):
    m = np.arange(6, dtype=np.float64).reshape(2, 3) / 7.0
    matrix = w.real(m, [("dim", w.ints([2, 3])),
                        ("dimnames", w.vlist([w.strs(["g1", "g2"]),
                                              w.strs(["a", "b", "c"])]))])
    plain = w.real(np.array([1.5, -2.25, 1e-300]))
    dimmed = w.real(m, [("dim", w.ints([2, 3]))])
    named = w.vlist([plain, w.ints([3, -1]), w.lgl([1, 0, -2147483648])],
                    [("names", w.strs(["x", "n", "flag"]))])
    s4 = w.s4("CogapsResult", [("featureLoadings", dimmed),
                               ("sampleFactors", matrix)])
    return [("matrix", matrix), ("named", named), ("s4", s4),
            ("strings", w.strs(["p", "q"]))]


def _header():
    return b"X\n" + _i(3) + _i(0x040300) + _i(0x030500) + _i(5) + b"UTF-8"


def _plain(x):
    """A structure of builtins and numpy arrays, the same for both
    packages' RObj/RS4 classes."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, _plain(dataclasses.asdict(x)))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        # repr: NA (nan) compares equal to itself
        return ("array", x.dtype.str, x.shape, [repr(v) for v in x.ravel()])
    return x


def test_read_rds_matches_jax(tmp_path):
    w = _Writer()
    obj = w.vlist([v for _, v in _objects(w)],
                  [("names", w.strs([k for k, _ in _objects(_Writer())]))])
    path = str(tmp_path / "x.rds")
    with open(path, "wb") as f:
        f.write(gzip.compress(_header() + obj))
    mine, theirs = rdata.read_rds(path), jrdata.read_rds(path)
    assert _plain(mine) == _plain(theirs)
    assert set(mine) == {"matrix", "named", "s4", "strings"}
    np.testing.assert_array_equal(rdata.unwrap(mine["matrix"]),
                                  np.arange(6).reshape(2, 3) / 7.0)
    assert mine["s4"].class_name == "CogapsResult"
    assert mine["named"]["n"].tolist() == [3, -1]


def test_read_rdata_matches_jax(tmp_path):
    w = _Writer()
    path = str(tmp_path / "x.rda")
    with open(path, "wb") as f:
        f.write(gzip.compress(b"RDX3\n" + _header() + w.pairlist(
            _objects(w))))
    mine, theirs = rdata.read_rdata(path), jrdata.read_rdata(path)
    assert _plain(mine) == _plain(theirs)
    assert list(mine) == ["matrix", "named", "s4", "strings"]
    assert mine["strings"] == ["p", "q"]
