"""The port's DataVec ETL (``datavec/``: record readers, the
RecordReader → DataSet/MultiDataSet iterators) against the JAX package's,
on the CPU.

Every case is one function of a package's ``datavec`` and ``datasets``
modules; it runs once through each package on the same inputs (written
or drawn from a seed with numpy) and returns a trace of what came out:
records, batches (every array with its dtype and bytes), masks, metadata,
cursor states and error messages. The two traces must be equal — bitwise,
since both packages run the same host numpy code. The cases are those of
``tests/test_datavec.py``, every ``AlignmentMode`` over seeded ragged
sequences, ``state``/``restore`` (within a package and across them),
``load_from_metadata``, and the label map of
``tests/test_durable.py::test_record_reader_iterator_keeps_label_map``.
Last, a CSV-fed ``fit`` of the port's ``MultiLayerNetwork`` equals an
array-fed one bitwise.
"""

import types

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.datasets as j_datasets
import deeplearning4j_tpu.datavec as j_datavec

import deeplearning4j_tpu_torch.datasets as t_datasets
import deeplearning4j_tpu_torch.datavec as t_datavec

JAX = types.SimpleNamespace(dv=j_datavec, ds=j_datasets, name="jax")
TORCH = types.SimpleNamespace(dv=t_datavec, ds=t_datasets, name="torch")

IRIS_ROWS = [
    "5.1,3.5,1.4,0.2,0",
    "4.9,3.0,1.4,0.2,0",
    "7.0,3.2,4.7,1.4,1",
    "6.4,3.2,4.5,1.5,1",
    "6.3,3.3,6.0,2.5,2",
    "5.8,2.7,5.1,1.9,2",
]


def canon(obj):
    """A comparable trace: arrays by dtype, shape and bytes, floats by
    their bits, datasets by their fields."""
    if isinstance(obj, np.ndarray):
        return ("array", obj.dtype.str, obj.shape, obj.tobytes())
    if torch.is_tensor(obj):
        return canon(obj.numpy())
    if isinstance(obj, (bool, np.bool_)):
        return ("bool", bool(obj))
    if isinstance(obj, (float, np.floating)):
        return ("float", type(obj).__name__, np.float64(obj).tobytes())
    if isinstance(obj, (int, np.integer)):
        return ("int", int(obj))
    if obj is None or isinstance(obj, str):
        return obj
    if isinstance(obj, dict):
        return ("dict", tuple((k, canon(v)) for k, v in obj.items()))
    if hasattr(obj, "_fields"):                       # RecordMetaData
        return ("meta",) + tuple(canon(v) for v in obj)
    if isinstance(obj, (list, tuple)):
        return ("seq", tuple(canon(v) for v in obj))
    if hasattr(obj, "features_masks"):                # MultiDataSet
        return ("mds", canon(list(obj.features)), canon(list(obj.labels)),
                canon(obj.features_masks), canon(obj.labels_masks))
    if hasattr(obj, "features_mask"):                 # DataSet
        return ("ds", canon(obj.features), canon(obj.labels),
                canon(obj.features_mask), canon(obj.labels_mask),
                obj.labels is obj.features,
                canon(getattr(obj, "example_metadata", None)))
    raise TypeError(type(obj))


def drain(it):
    out = []
    while it.has_next():
        out.append(it.next())
    return out


def error_of(fn):
    try:
        fn()
    except Exception as e:                            # noqa: BLE001
        return (type(e).__name__, str(e))
    return None


# ----------------------------------------------------------------------
# cases: each returns a trace
# ----------------------------------------------------------------------

def case_csv_file_reset(p, tmp):
    path = tmp / "iris.csv"
    path.write_text("a,b,c,d,label\n" + "\n".join(IRIS_ROWS) + "\n")
    rr = p.dv.CSVRecordReader(path=str(path), skip_lines=1)
    recs = list(rr)
    after = rr.has_next()
    rr.reset()
    return [recs, after, rr.has_next(), len(rr), rr.state()]


def case_classification_one_hot(p, tmp):
    it = p.dv.RecordReaderDataSetIterator(
        p.dv.CSVRecordReader(lines=IRIS_ROWS), batch_size=4, label_index=4,
        num_classes=3)
    first = drain(it)
    it.reset()
    return [first, drain(it)]


def case_string_labels(p, tmp):
    rows = ["1.0,2.0,cat", "3.0,4.0,dog", "5.0,6.0,cat", "7,8,bird"]
    it = p.dv.RecordReaderDataSetIterator(
        p.dv.CSVRecordReader(lines=rows), batch_size=3, label_index=2,
        num_classes=3)
    return [drain(it), it.state()]


def case_regression(p, tmp):
    it = p.dv.RecordReaderDataSetIterator(
        p.dv.CSVRecordReader(lines=["1,2,10,20", "3,4,30,40", "5,6,50,60"]),
        batch_size=2, label_index=2, label_index_to=3, regression=True)
    return drain(it)


def case_unsupervised(p, tmp):
    it = p.dv.RecordReaderDataSetIterator(
        p.dv.CollectionRecordReader([[1.0, 2.0], [3.0, 4.0]]), batch_size=2)
    return drain(it)


def case_ndarray_writable(p, tmp):
    rr = p.dv.CollectionRecordReader([
        [np.arange(4, dtype=np.float32).reshape(2, 2), 1],
        [np.ones((2, 2), dtype=np.float64), 0],
        [np.arange(4, dtype=np.int64).reshape(4), 1],
    ])
    return drain(p.dv.RecordReaderDataSetIterator(
        rr, batch_size=2, label_index=1, num_classes=2))


def case_max_num_batches(p, tmp):
    it = p.dv.RecordReaderDataSetIterator(
        p.dv.CSVRecordReader(lines=IRIS_ROWS), batch_size=2, label_index=4,
        num_classes=3, max_num_batches=2)
    return [list(it), it.state()]


def case_metadata_reload(p, tmp):
    it = p.dv.RecordReaderDataSetIterator(
        p.dv.CSVRecordReader(lines=IRIS_ROWS), batch_size=3, label_index=4,
        num_classes=3, collect_metadata=True)
    ds = it.next()
    before = list(it.last_metadata)
    back = it.load_from_metadata(ds.example_metadata[1:3])
    return [ds, back, it.last_metadata == before, it.collect_metadata,
            [m.location() for m in before], it.next()]


def case_collection_metadata(p, tmp):
    recs = [[float(i), float(i % 2)] for i in range(6)]
    it = p.dv.RecordReaderDataSetIterator(
        p.dv.CollectionRecordReader(recs), batch_size=3, num_classes=2,
        label_index=1, collect_metadata=True)
    it.next()
    before = list(it.last_metadata)
    ds = it.load_from_metadata(before[:2])
    return [ds, it.last_metadata, it.collect_metadata]


def case_errors(p, tmp):
    dv = p.dv
    out_of_range = dv.RecordReaderDataSetIterator(
        dv.CSVRecordReader(lines=["1,2,7"]), batch_size=1, label_index=2,
        num_classes=3)
    multi = (dv.RecordReaderMultiDataSetIterator.Builder(batch_size=1)
             .add_reader("csv", dv.CSVRecordReader(lines=["1,2,7"]))
             .add_input("csv", 0, 1).add_output_one_hot("csv", 2, 3)
             .build())
    feats = dv.CollectionSequenceRecordReader([[[1.0], [2.0]], [[4.0]]])
    labels = dv.CollectionSequenceRecordReader([[[0], [1]], [[1]]])
    ragged = dv.SequenceRecordReaderDataSetIterator(
        feats, batch_size=2, num_classes=2, labels_reader=labels)
    short = dv.SequenceRecordReaderDataSetIterator(
        dv.CollectionSequenceRecordReader([[[1.0]], [[2.0]]]),
        batch_size=2, num_classes=2,
        labels_reader=dv.CollectionSequenceRecordReader([[[0]]]))
    return [
        error_of(out_of_range.next),
        error_of(multi.next),
        error_of(ragged.next),
        error_of(lambda: list(short)),
        error_of(lambda: dv.RecordReaderDataSetIterator(
            dv.CSVRecordReader(lines=["1,2,cat"]), batch_size=2,
            label_index=2)),
        error_of(lambda: dv.RecordReaderDataSetIterator(
            dv.CSVRecordReader(lines=["1,2"]), batch_size=1,
            label_index_to=1)),
        error_of(lambda: dv.CSVRecordReader()),
        error_of(lambda: dv.SequenceRecordReaderDataSetIterator(
            dv.CollectionSequenceRecordReader([]), batch_size=1)),
        error_of(dv.RecordReaderDataSetIterator(
            dv.CollectionRecordReader([["x", 1.0]]), batch_size=1,
            label_index=1, regression=True).next),
    ]


def case_sequence_single_reader(p, tmp):
    seqs = [
        [[0.1, 0.2, 0], [0.3, 0.4, 1], [0.5, 0.6, 0]],
        [[1.1, 1.2, 2], [1.3, 1.4, 2], [1.5, 1.6, 1]],
        [[2.1, 2.2, 1], [2.3, 2.4, 0], [2.5, 2.6, 2]],
    ]
    it = p.dv.SequenceRecordReaderDataSetIterator(
        p.dv.CollectionSequenceRecordReader(seqs), batch_size=2,
        num_classes=3, label_index=2)
    return [drain(it), it.state()]


def case_sequence_regression(p, tmp):
    seqs = [[[0.5, 1.0, 2.0], [1.5, 3.0, 4.0]], [[2.5, 5.0, 6.0],
                                                 [3.5, 7.0, 8.0]]]
    it = p.dv.SequenceRecordReaderDataSetIterator(
        p.dv.CollectionSequenceRecordReader(seqs), batch_size=2,
        label_index=0, regression=True)
    return drain(it)


def _ragged_sequences(seed, n, equal):
    rng = np.random.default_rng(seed)
    feats, labels = [], []
    for _ in range(n):
        t_f = 4 if equal else int(rng.integers(1, 6))
        t_l = t_f if equal else int(rng.integers(1, 6))
        feats.append(rng.normal(size=(t_f, 3)).round(4).tolist())
        labels.append([[int(v)] for v in rng.integers(0, 3, t_l)])
    return feats, labels


@pytest.mark.parametrize("alignment", ["equal_length", "align_start",
                                       "align_end"])
def test_every_alignment_mode_bitwise(alignment, tmp_path):
    def case(p, tmp):
        mode = {"equal_length": p.dv.AlignmentMode.EQUAL_LENGTH,
                "align_start": p.dv.AlignmentMode.ALIGN_START,
                "align_end": p.dv.AlignmentMode.ALIGN_END}[alignment]
        feats, labels = _ragged_sequences(
            11, 7, equal=alignment == "equal_length")
        it = p.dv.SequenceRecordReaderDataSetIterator(
            p.dv.CollectionSequenceRecordReader(feats), batch_size=3,
            num_classes=3,
            labels_reader=p.dv.CollectionSequenceRecordReader(labels),
            alignment=mode)
        batches = drain(it)
        return [batches, [b.features_mask is None for b in batches]]
    assert_same(case, tmp_path)


def case_dual_reader_label_order(p, tmp):
    feats = p.dv.CollectionSequenceRecordReader([[[0.1], [0.2]],
                                                 [[0.3], [0.4]]])
    labels = p.dv.CollectionSequenceRecordReader([[["b"], ["b"]],
                                                  [["a"], ["c"]]])
    labels.labels = ["a", "b"]
    it = p.dv.SequenceRecordReaderDataSetIterator(
        feats, batch_size=2, num_classes=3, labels_reader=labels)
    return [drain(it), it.state()]


def case_csv_sequence_files(p, tmp):
    paths = []
    for i in range(3):
        path = tmp / f"seq{i}.csv"
        path.write_text("h1,h2\n" + "\n".join(
            f"{i}.{t},{t}" for t in range(2 + i)) + "\n")
        paths.append(str(path))
    rr = p.dv.CSVSequenceRecordReader(paths=paths, skip_lines=1)
    seq = rr.next_sequence()
    meta = rr.record_metadata()
    return [seq, meta.index, len(rr), rr.load_from_metadata([meta]),
            rr.state()]


def case_sequence_flat_contract(p, tmp):
    rr = p.dv.CSVSequenceRecordReader(
        sequences=[[[0.0, 1.0], [2.0, 3.0]], [], [[4.0, 5.0]], []])
    flat, metas = [], []
    while rr.has_next():
        flat.append(rr.next_record())
        metas.append(rr.record_metadata())
    rr.reset()
    return [flat, metas, rr.next_sequence(), rr.state()]


def case_multi_dataset_iterator(p, tmp):
    rng = np.random.default_rng(5)
    a = [[float(v) for v in rng.normal(size=3).round(3)]
         + [["x", "y", "z"][i % 3]] for i in range(7)]
    b = [[float(i), float(i * i)] for i in range(7)]
    it = (p.dv.RecordReaderMultiDataSetIterator.Builder(batch_size=3)
          .add_reader("a", p.dv.CollectionRecordReader(a))
          .add_reader("b", p.dv.CollectionRecordReader(b))
          .add_input("a", 0, 1).add_input("b", 0, 1)
          .add_output("a", 2, 2).add_output_one_hot("a", 3, 3)
          .build())
    first = list(it)
    it.reset()
    return [first, it.has_next(), it.batch_size]


def case_multi_dataset_iris(p, tmp):
    it = (p.dv.RecordReaderMultiDataSetIterator.Builder(batch_size=4)
          .add_reader("csv", p.dv.CSVRecordReader(lines=IRIS_ROWS))
          .add_input("csv", 0, 1).add_input("csv", 2, 3)
          .add_output_one_hot("csv", 4, 3).build())
    return [list(it), error_of(
        p.dv.RecordReaderMultiDataSetIterator.Builder(2).build)]


def case_declared_labels(p, tmp):
    class LabeledReader(p.dv.CollectionRecordReader):
        @property
        def labels(self):
            return ["cat", "dog", "bird"]

    it = p.dv.RecordReaderDataSetIterator(
        LabeledReader([[1.0, "cat"], [2.0, "dog"], [3.0, "bird"]]),
        batch_size=2, label_index=1)
    return [it.num_classes, drain(it)]


def case_line_reader(p, tmp):
    path = tmp / "lines.txt"
    path.write_text("hello world\nsecond line\n")
    rr = p.dv.LineRecordReader(path=str(path))
    recs = [rr.next_record(), rr.record_metadata()]
    st = rr.state()
    recs.append(rr.next_record())
    rr.restore(st)
    recs.append(rr.next_record())
    return recs


def case_label_map_cursor(p, tmp):
    """tests/test_durable.py::test_record_reader_iterator_keeps_label_map:
    the lazily grown string→index map rides the cursor."""
    records = [[float(i), ["a", "b", "c"][i % 3]] for i in range(12)]
    it = p.dv.RecordReaderDataSetIterator(
        p.dv.CollectionRecordReader(records), batch_size=4, label_index=1,
        num_classes=3)
    it.next()
    st = it.state()
    rest = [it.next() for _ in range(2)]
    it2 = p.dv.RecordReaderDataSetIterator(
        p.dv.CollectionRecordReader(records), batch_size=4, label_index=1,
        num_classes=3)
    it2.restore(st)
    return [st, rest, [it2.next() for _ in range(2)], it.seekable()]


def case_sequence_cursor(p, tmp):
    feats, labels = _ragged_sequences(3, 6, equal=False)
    mk = lambda: p.dv.SequenceRecordReaderDataSetIterator(  # noqa: E731
        p.dv.CollectionSequenceRecordReader(feats), batch_size=2,
        num_classes=3,
        labels_reader=p.dv.CollectionSequenceRecordReader(labels),
        alignment=p.dv.AlignmentMode.ALIGN_END)
    it = mk()
    it.next()
    st = it.state()
    rest = drain(it)
    it2 = mk()
    it2.restore(st)
    return [st, rest, drain(it2), it.seekable()]


def case_seeded_numeric_csv(p, tmp):
    """A seeded numeric CSV file (the native parser's path in both
    packages) through the classification iterator, with a header."""
    rng = np.random.default_rng(2024)
    x = rng.normal(size=(97, 6))
    lab = rng.integers(0, 4, 97)
    path = tmp / "seeded.csv"
    path.write_text("f0,f1,f2,f3,f4,f5,y\n" + "\n".join(
        ",".join(repr(float(v)) for v in row) + f",{c}"
        for row, c in zip(x, lab)) + "\n")
    rr = p.dv.CSVRecordReader(path=str(path), skip_lines=1)
    it = p.dv.RecordReaderDataSetIterator(rr, batch_size=32, label_index=6,
                                          num_classes=4)
    return [rr.load_from_metadata([p.dv.RecordMetaData(5, str(path))]),
            drain(it)]


CASES = {name[5:]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


def assert_same(case, tmp):
    want = canon(case(JAX, tmp))
    got = canon(case(TORCH, tmp))
    assert got == want


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_bitwise(name, tmp_path):
    assert_same(CASES[name], tmp_path)


@pytest.mark.parametrize("src,dst", [(JAX, TORCH), (TORCH, JAX)],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_cursor_restores_across_packages(src, dst):
    """A cursor taken in one package resumes the other's iterator on the
    same records with the same remaining batches."""
    records = [[float(i), ["p", "q", "r", "s"][(i * 7) % 4]]
               for i in range(14)]

    def mk(pkg):
        return pkg.dv.RecordReaderDataSetIterator(
            pkg.dv.CollectionRecordReader(records), batch_size=3,
            label_index=1, num_classes=4)

    a = mk(src)
    a.next()
    a.next()
    st = a.state()
    want = canon(drain(a))
    b = mk(dst)
    b.restore(st)
    assert canon(drain(b)) == want


def test_csv_fed_fit_equals_array_fed_fit(tmp_path):
    """fit over RecordReaderDataSetIterator (a pixel CSV scaled by 1/255,
    as the card's ETL phase does) trains the port's MultiLayerNetwork to
    the same parameters, bitwise, as fit over ArrayDataSetIterator of the
    same arrays in the same order."""
    from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf.builders import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    rng = np.random.default_rng(7)
    pixels = rng.integers(0, 256, (40, 16))
    labels = rng.integers(0, 10, 40)
    path = tmp_path / "pixels.csv"
    path.write_text("\n".join(
        f"{c}," + ",".join(str(int(v)) for v in row)
        for row, c in zip(pixels, labels)) + "\n")

    def scale(ds):
        ds.features = ds.features / np.float32(255.0)
        return ds

    def net():
        conf = (NeuralNetConfiguration.builder().seed(3).updater("adam")
                .learning_rate(1e-3).list()
                .layer(DenseLayer(n_out=12, activation="relu"))
                .layer(OutputLayer(n_out=10, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.feed_forward(16)).build())
        return MultiLayerNetwork(conf, device="cpu").init()

    a, b = net(), net()
    for (v, ps) in a.params.items():
        for k, t in ps.items():
            assert torch.equal(t, b.params[v][k])
    reader = t_datavec.CSVRecordReader(path=str(path))
    a.fit(t_datavec.RecordReaderDataSetIterator(
        reader, 8, label_index=0, num_classes=10, preprocessor=scale))
    x = pixels.astype(np.float32) / np.float32(255.0)
    y = np.eye(10, dtype=np.float32)[labels]
    b.fit(ArrayDataSetIterator(x, y, 8))
    assert a.iteration_count == b.iteration_count == 5
    for (v, ps) in a.params.items():
        for k, t in ps.items():
            assert torch.equal(t, b.params[v][k]), (v, k)
