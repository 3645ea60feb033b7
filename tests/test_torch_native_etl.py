"""The port's native CSV parser (``datavec/_fastcsv.cpp``, built by
``util/native.py`` with g++ and bound by ``datavec/native.py``) against
the JAX package's, on the CPU: the 13 cases of
``tests/test_native_etl.py``, each run through both packages on the same
bytes and compared bitwise (the parsed matrices, the records, and the
cases that decline to the Python path), plus the loader's own contract —
the library cached under ``build/native/<stem>-<hash>.so`` at the
checkout's root, a warning and None when the build fails.
"""

import unittest.mock as mock
import warnings
from pathlib import Path

import numpy as np
import pytest

import deeplearning4j_tpu.datavec.native as j_native
from deeplearning4j_tpu.datavec.readers import CSVRecordReader as JReader

import deeplearning4j_tpu_torch.datavec.native as t_native
from deeplearning4j_tpu_torch.datavec.iterator import \
    RecordReaderDataSetIterator
from deeplearning4j_tpu_torch.datavec.readers import CSVRecordReader
from deeplearning4j_tpu_torch.util import native as t_loader

REPO = Path(__file__).resolve().parents[1]


def same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def parse_both(data, **kw):
    got = t_native.parse_numeric_csv(data, **kw)
    want = j_native.parse_numeric_csv(data, **kw)
    assert same(got, want), (got, want)
    return got


def records(reader):
    out = []
    while reader.has_next():
        out.append(reader.next_record())
    return out


def bits(recs):
    return [[(type(v).__name__, np.float64(v).tobytes())
             if isinstance(v, float) else v for v in r] for r in recs]


class TestBuild:
    def test_library_built_from_the_ports_own_source(self):
        lib = t_native.load()
        assert lib is not None
        src = REPO / "deeplearning4j_tpu_torch" / "datavec" / "_fastcsv.cpp"
        assert t_native._SRC == src
        so = t_loader.library_path(src)
        assert so.parent == REPO / "build" / "native"
        assert so.name.startswith("_fastcsv-") and so.exists()
        assert lib._name == str(so)
        # the port's copy is its own file, byte for byte the reference's
        ref = REPO / "deeplearning4j_tpu" / "datavec" / "_fastcsv.cpp"
        assert src.read_bytes() == ref.read_bytes()

    def test_failed_build_warns_and_returns_none(self, tmp_path):
        bad = tmp_path / "broken.cpp"
        bad.write_text("this is not C++\n")
        with pytest.warns(UserWarning, match="native build of broken.cpp"):
            assert t_loader.compile_and_load(bad) is None
        assert not t_loader.library_path(bad).exists()
        assert not list(t_loader.BUILD_ROOT.glob("broken-*"))
        assert t_loader.compile_and_load(tmp_path / "absent.cpp") is None

    def test_no_compiler_keeps_the_python_path(self, monkeypatch):
        """Without a library the reader parses in Python and yields the
        same records."""
        text = "1,2.5\n3,4\n"
        fast = records(CSVRecordReader(lines=text.splitlines()))
        monkeypatch.setattr(t_native, "load", lambda: None)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            slow = records(CSVRecordReader(lines=text.splitlines()))
        assert bits(fast) == bits(slow)


class TestNativeParse:
    def test_basic_matrix(self):
        m = parse_both(b"1,2.5,3\n-4,5e2,.5\n")
        np.testing.assert_array_equal(m, [[1, 2.5, 3], [-4, 500, 0.5]])

    def test_skip_lines_and_crlf(self):
        m = parse_both(b"a,b\r\n1,2\r\n3,4\r\n", skip_lines=1)
        np.testing.assert_array_equal(m, [[1, 2], [3, 4]])

    def test_custom_delimiter(self):
        m = parse_both(b"1;2\n3;4\n", delimiter=";")
        np.testing.assert_array_equal(m, [[1, 2], [3, 4]])

    def test_whitespace_tolerance(self):
        m = parse_both(b" 1 , 2 \n 3 , 4 \n")
        np.testing.assert_array_equal(m, [[1, 2], [3, 4]])

    def test_rejects_strings_ragged_empty_fields(self):
        assert parse_both(b"a,b\n1,2\n") is None
        assert parse_both(b"1,2\n3\n") is None
        assert parse_both(b"1,,3\n4,5,6\n") is None

    def test_trailing_newline_and_blank_lines(self):
        m = parse_both(b"1,2\n\n3,4\n\n")
        np.testing.assert_array_equal(m, [[1, 2], [3, 4]])

    def test_seeded_matrix_bitwise(self):
        """Every float64 written with repr parses to the same bits in both
        packages and equals Python's float()."""
        x = np.random.default_rng(31).normal(size=(64, 9)) * 10.0 ** \
            np.random.default_rng(32).integers(-8, 8, (64, 9))
        text = "\n".join(",".join(repr(float(v)) for v in row) for row in x)
        m = parse_both(text.encode())
        assert m.tobytes() == x.tobytes()


class TestReaderParity:
    """CSVRecordReader yields the same records whichever path parsed and
    whichever package read."""

    def _python_path_records(self, text, **kw):
        with mock.patch.object(t_native, "parse_numeric_csv",
                               lambda *a, **k: None):
            return records(CSVRecordReader(lines=text.splitlines(), **kw))

    def test_numeric_file_identical_records(self):
        text = "1,2.5,3\n4,5,60\n7,8,9\n"
        fast = records(CSVRecordReader(lines=text.splitlines()))
        assert bits(fast) == bits(self._python_path_records(text))
        assert bits(fast) == bits(records(JReader(lines=text.splitlines())))
        assert all(isinstance(v, float) for r in fast for v in r)

    def test_string_file_still_works(self):
        lines = ["1,alpha", "2,beta"]
        got = records(CSVRecordReader(lines=lines))
        assert got == [[1.0, "alpha"], [2.0, "beta"]]
        assert bits(got) == bits(records(JReader(lines=lines)))

    def test_iterator_end_to_end_over_native_path(self):
        from deeplearning4j_tpu.datavec.iterator import \
            RecordReaderDataSetIterator as JIter
        lines = [f"{i*0.1},{i*0.2},{i % 3}" for i in range(30)]
        ds = RecordReaderDataSetIterator(
            CSVRecordReader(lines=lines), batch_size=10, label_index=2,
            num_classes=3).next()
        ref = JIter(JReader(lines=lines), batch_size=10, label_index=2,
                    num_classes=3).next()
        assert ds.features.shape == (10, 2) and ds.labels.shape == (10, 3)
        assert same(ds.features, ref.features)
        assert same(ds.labels, ref.labels)

    def test_file_read_native_and_python_equal(self, tmp_path):
        rng = np.random.default_rng(4)
        x = rng.integers(0, 256, (50, 12))
        p = tmp_path / "px.csv"
        p.write_text("h" + ",h" * 11 + "\n" + "\n".join(
            ",".join(str(int(v)) for v in row) for row in x) + "\n")
        calls = []
        real = t_native.parse_numeric_csv

        def counted(*a, **k):
            out = real(*a, **k)
            calls.append(out is not None)
            return out

        with mock.patch.object(t_native, "parse_numeric_csv", counted):
            fast = records(CSVRecordReader(path=str(p), skip_lines=1))
        assert calls == [True]
        with mock.patch.object(t_native, "parse_numeric_csv",
                               lambda *a, **k: None):
            slow = records(CSVRecordReader(path=str(p), skip_lines=1))
        assert bits(fast) == bits(slow) == bits(
            records(JReader(path=str(p), skip_lines=1)))
        assert fast == x.astype(np.float64).tolist()


class TestFloatSemanticsParity:
    """Whatever float() rejects (hex, embedded NULs) declines to the
    Python path in both packages."""

    def test_hex_stays_categorical(self):
        lines = ["0x1A,1", "0x2B,2"]
        assert CSVRecordReader(lines=lines).next_record() == ["0x1A", 1.0]
        assert bits(records(CSVRecordReader(lines=lines))) == \
            bits(records(JReader(lines=lines)))

    def test_nul_contaminated_field_falls_back(self):
        assert parse_both(b"1\x00junk,2\n") is None

    def test_nan_inf_fall_back_but_parse_like_float(self):
        assert parse_both(b"nan,1\ninf,2\n") is None
        got = records(CSVRecordReader(lines=["nan,1", "inf,2"]))
        want = records(JReader(lines=["nan,1", "inf,2"]))
        assert np.isnan(got[0][0]) and got[0][1] == 1.0
        assert bits(got) == bits(want)

    def test_skip_lines_with_embedded_newlines_in_elements(self):
        lines = ["1,2\n3,4", "5,6"]
        got = records(CSVRecordReader(lines=lines, skip_lines=1))
        assert got == [[5.0, 6.0]]
        assert bits(got) == bits(records(JReader(lines=lines, skip_lines=1)))
