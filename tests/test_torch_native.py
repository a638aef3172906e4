"""The port's own native library (``smartcal_tpu_torch.native``) against
the JAX package's: the ``.sct`` store is a contract, so a file the port
writes is byte-identical to the JAX package's from the same columns, each
package reads the other's, and the pure-Python reader decodes both; the
C++ sum tree gives the same leaves, totals and samples.  A failed g++
build raises with the compiler's output (no silent npz fallback);
``SMARTCAL_MS_FORMAT=npz`` chooses npz explicitly.  Everything is exact.
"""

import numpy as np
import pytest

from smartcal_tpu import native as jnative
from smartcal_tpu_torch import native

DTYPES = ("float32", "float64", "int32", "int64", "complex64",
          "complex128", "uint8")


def _col(rng, dtype, shape):
    if dtype.startswith("complex"):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(dtype)
    if dtype.startswith("float"):
        return rng.standard_normal(shape).astype(dtype)
    return rng.integers(-100, 100, shape).astype(dtype)


def _table(rng):
    cols = {f"MAIN/{d}": _col(rng, d, (5, 1, 3)) for d in DTYPES}
    cols.update({"META/scalar": np.float64(42.5),
                 "META/empty": np.zeros((0, 3), np.float32),
                 "META/flag": np.array([True, False, True]),
                 "META/strided": np.arange(24, dtype=np.float32)
                 .reshape(4, 6)[:, ::2]})
    return cols


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(), (7,), (3, 0, 2), (4, 1, 4)])
def test_sct_round_trip_every_dtype(tmp_path, dtype, shape):
    col = _col(np.random.default_rng(0), dtype, shape)
    path = str(tmp_path / "t.sct")
    native.sct_write(path, {"c": col})
    back = native.sct_read(path)["c"]
    assert back.dtype == col.dtype and back.shape == col.shape
    np.testing.assert_array_equal(back, col)
    np.testing.assert_array_equal(native.sct_read_one(path, "c"), col)
    np.testing.assert_array_equal(native.py_read(path)["c"], col)


def test_sct_files_byte_identical_and_cross_read(tmp_path):
    cols = _table(np.random.default_rng(1))
    mine, theirs = str(tmp_path / "port.sct"), str(tmp_path / "jax.sct")
    native.sct_write(mine, cols)
    jnative.sct_write(theirs, cols)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for reader in (native.sct_read, jnative.sct_read, native.py_read):
        for path in (mine, theirs):
            back = reader(path)
            assert list(back) == list(cols)
            for k, v in cols.items():
                want = np.asarray(v)
                if want.dtype == np.bool_:
                    want = want.astype(np.uint8)
                np.testing.assert_array_equal(back[k], want)
                assert back[k].dtype == want.dtype


def test_python_reader_single_column_and_bad_files(tmp_path):
    cols = _table(np.random.default_rng(2))
    path = str(tmp_path / "t.sct")
    jnative.sct_write(path, cols)
    np.testing.assert_array_equal(native.py_read(path, only="MAIN/int64"),
                                  cols["MAIN/int64"])
    with pytest.raises(KeyError):
        native.py_read(path, only="nope")
    with pytest.raises(KeyError):
        native.sct_read_one(path, "nope")
    bad = tmp_path / "bad.sct"
    bad.write_bytes(b"NOPE" + b"\0" * 64)
    with pytest.raises(IOError):
        native.py_read(str(bad))
    with pytest.raises(IOError):
        native.sct_read(str(bad))
    trunc = tmp_path / "trunc.sct"
    trunc.write_bytes(open(path, "rb").read()[:40])
    with pytest.raises(IOError):
        native.py_read(str(trunc))


def test_sumtree_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    mine, theirs = native.SumTree(100), jnative.SumTree(100)
    assert mine.capacity == theirs.capacity == 128
    for p in rng.random(150) * 5.0:                # wraps the ring
        assert mine.add(p) == theirs.add(p)
    leaves = rng.integers(0, 128, 20)
    pri = rng.random(20)
    mine.update_batch(leaves, pri)
    theirs.update_batch(leaves, pri)
    mine.update(3, 7.5)
    theirs.update(3, 7.5)
    for name in ("filled", "cursor"):
        assert getattr(mine, name) == getattr(theirs, name)
    for name in ("total", "max_priority"):
        assert getattr(mine, name)() == getattr(theirs, name)()
    np.testing.assert_array_equal(mine.leaves(), theirs.leaves())
    u = rng.random(16)
    for a, b in zip(mine.sample_stratified(16, u),
                    theirs.sample_stratified(16, u)):
        np.testing.assert_array_equal(a, b)
    for v in rng.random(10) * mine.total():
        assert mine.get_leaf(v) == theirs.get_leaf(v)
    mine.set_state(theirs.leaves(), 5, 77)
    assert (mine.cursor, mine.filled) == (5, 77)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    from smartcal_tpu_torch.ops import build as ops_build

    monkeypatch.setattr(ops_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-no-such-flag-for-gxx",))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native build failed"):
        native.sct_write(str(tmp_path / "t.sct"), {"a": np.zeros(2)})
    assert not list(tmp_path.glob("native/*.so"))


def test_available_matches_jax_and_says_false_on_a_failed_build(
        tmp_path, monkeypatch):
    from smartcal_tpu_torch.ops import build as ops_build

    assert native.available() is jnative.available() is True
    monkeypatch.setattr(ops_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-no-such-flag-for-gxx",))
    monkeypatch.setattr(native, "_lib", None)
    assert native.available() is False


def test_library_is_hash_named_in_the_build_dir():
    path = native.library_path()
    assert path.parent.name == "native"
    assert path.name.startswith("libsmartcal_native-")
    native.lib()
    assert path.exists()


def test_ms_format_switch(tmp_path, monkeypatch):
    from smartcal_tpu_torch.cal import ms_io

    main = {"TIME": np.zeros(3), "ANTENNA1": np.zeros(3, np.int32),
            "ANTENNA2": np.ones(3, np.int32),
            "DATA": np.zeros((3, 1, 4), np.complex64)}
    meta = {"N_ANTENNA": np.int64(2)}
    monkeypatch.delenv("SMARTCAL_MS_FORMAT", raising=False)
    ms_io._store(str(tmp_path / "a.MS"), main, meta)
    assert ms_io.is_sct_ms(str(tmp_path / "a.MS"))
    monkeypatch.setenv("SMARTCAL_MS_FORMAT", "npz")
    ms_io._store(str(tmp_path / "a.MS"), main, meta)
    assert not ms_io.is_sct_ms(str(tmp_path / "a.MS"))
    assert (tmp_path / "a.MS" / ms_io.MAIN).exists()
    monkeypatch.setenv("SMARTCAL_MS_FORMAT", "zip")
    with pytest.raises(ValueError):
        ms_io._store(str(tmp_path / "b.MS"), main, meta)


@pytest.mark.parametrize("rel_path", ["native/_src/sct.cc",
                                      "native/_src/sumtree.cc",
                                      "data/ateam.sky", "data/ateam.cluster",
                                      "data/ateam.rho"])
def test_port_keeps_its_own_copies(rel_path):
    """The port's native sources and A-team fixture are copies of the JAX
    package's files, byte for byte (the port imports neither)."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "smartcal_tpu_torch", rel_path), "rb") as a, \
            open(os.path.join(root, "smartcal_tpu", rel_path), "rb") as b:
        assert a.read() == b.read()
