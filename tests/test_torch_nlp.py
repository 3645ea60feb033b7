"""The port's embedding stack (``nlp/``) against the JAX package's, on the
CPU.

The same numpy-seeded inputs go through both packages (the port with
``device="cpu"``):

- host code — tokens, sentence and label-aware iterators, vocabulary
  indices and counts, Huffman codes/points/lengths, ``_pairs`` batches and
  negative draws (skip-gram and CBOW, batch sizes 64 and 257, as in
  ``tests/test_nlp.py::TestPairGenerationParity``), the inverted index and
  the vectorizers' arrays: bitwise;
- single steps — ``ns_step``, ``hs_step`` and ``ns_step_scan`` (skip-gram
  and CBOW) from the same tables and batch, with heavy row collisions:
  every table within ``STEP_ATOL`` absolute, the loss within
  ``STEP_RTOL`` relative (float sums in another order);
- whole seeded runs — ``Word2Vec.fit`` (negative sampling and HS),
  ``ParagraphVectors.fit_documents`` (DBOW and DM) and ``infer_vector``,
  ``Glove.fit``: ``syn0`` within ``FIT_ATOL`` and ``similarity`` within it;
- the word-vector files — text and Google binary, written by either
  package and read by the other, vectors bitwise equal;
- the reference's tables carried across (``learning.params_from_numpy``):
  the same ``similarity`` and ``words_nearest``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deeplearning4j_tpu.nlp as j_nlp
from deeplearning4j_tpu.nlp import learning as j_learning
import deeplearning4j_tpu_torch.nlp as t_nlp
from deeplearning4j_tpu_torch.nlp import learning as t_learning

STEP_ATOL = 1e-6
STEP_RTOL = 1e-6
FIT_ATOL = 1e-5


def corpus(n=120, seed=0):
    """Two topic clusters (as ``tests/test_nlp.py``'s synthetic corpus)."""
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "pet", "fur", "tail"] + \
        [f"animal{i}" for i in range(15)]
    vehicles = ["car", "road", "wheel", "drive", "engine"] + \
        [f"vehicle{i}" for i in range(15)]
    return [list(rng.choice(animals if rng.random() < 0.5 else vehicles,
                            size=8)) for _ in range(n)]


def ragged_corpus():
    """``TestPairGenerationParity``'s corpus: 120 sequences of 2-39 tokens."""
    words = [f"w{i}" for i in range(50)]
    crng = np.random.default_rng(0)
    return [[words[i] for i in crng.integers(0, 50, crng.integers(2, 40))]
            for _ in range(120)]


def syn0_err(j_model, t_model):
    return float(np.abs(np.asarray(j_model._syn0())
                        - t_model._syn0()).max())


# ----------------------------------------------------------------------
# host code, bitwise
# ----------------------------------------------------------------------


@pytest.mark.parametrize("factory", ["default", "common", "ngram"])
def test_tokens_are_the_references(factory):
    text = 'Hello, World! 42 "quoted" the walks walked  a b'
    make = {"default": lambda m: m.DefaultTokenizerFactory(),
            "common": lambda m: m.DefaultTokenizerFactory(
                m.CommonPreprocessor()),
            "ngram": lambda m: m.NGramTokenizerFactory(1, 3)}[factory]
    assert (make(t_nlp).create(text).get_tokens()
            == make(j_nlp).create(text).get_tokens())


def test_sentence_and_document_iterators_are_the_references(tmp_path):
    (tmp_path / "a.txt").write_text("line one\n\nline two\n")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.txt").write_text("three\n")
    for lbl, body in (("pos", "good day"), ("neg", "bad day")):
        (tmp_path / "docs" / lbl).mkdir(parents=True)
        (tmp_path / "docs" / lbl / "d.txt").write_text(body)

    def trace(m):
        docs = [m.LabelledDocument(f"text {i}", [f"L{i % 3}"])
                for i in range(7)]
        it = m.AsyncLabelAwareIterator(m.SimpleLabelAwareIterator(docs), 2)
        first = [(d.content, d.labels) for d in it]
        it.reset()
        again = [(d.content, d.labels) for d in it]
        basic = m.BasicLabelAwareIterator(["x y", "z"])
        files = m.FileLabelAwareIterator(str(tmp_path / "docs"))
        return (list(m.CollectionSentenceIterator(["one", " two ", "",
                                                   "three"])),
                list(m.BasicLineIterator(str(tmp_path / "a.txt"))),
                list(m.FileSentenceIterator(str(tmp_path))),
                first, again, it.labels_source.labels,
                [(d.content, d.labels) for d in basic],
                [(d.content, d.labels) for d in files],
                files.labels_source.labels)

    assert trace(t_nlp) == trace(j_nlp)


def test_vocab_and_huffman_are_the_references():
    seqs = ragged_corpus() + corpus(40)

    def trace(m):
        vocab = m.vocab.VocabConstructor(min_word_frequency=2).build(seqs)
        h = m.Huffman(vocab)
        max_len = h.apply()
        codes, points, lengths = h.padded_tables()
        return (vocab.words(), vocab.counts_array().tolist(),
                vocab.total_word_count, max_len,
                [(w.codes, w.points) for w in vocab.vocab_words()],
                codes.tobytes(), points.tobytes(), lengths.tobytes(),
                codes.shape)

    assert trace(t_nlp) == trace(j_nlp)


@pytest.mark.parametrize("use_cbow", [False, True])
@pytest.mark.parametrize("batch_size", [64, 257])
def test_pairs_and_negatives_are_the_references(use_cbow, batch_size):
    seqs = ragged_corpus()

    def batches(m, **kw):
        sv = m.SequenceVectors(layer_size=8, window=3, batch_size=batch_size,
                               use_cbow=use_cbow, sample=1e-3, **kw)
        sv.build_vocab(seqs)
        rng = np.random.default_rng(9)
        out = []
        for batch in sv._pairs(seqs, rng):
            out.append([(a.dtype.str, a.shape, a.tobytes()) for a in
                        (*batch, sv._draw_negatives(rng, batch[1]))])
        return out

    got = batches(t_nlp, device="cpu")
    assert len(got) >= 3
    assert got == batches(j_nlp)


def test_inverted_index_and_unigram_table_are_the_references():
    def trace(m, learning):
        idx = m.InvertedIndex()
        for toks in corpus(30):
            idx.add_words_to_doc(None, toks)
        idx.add_words_to_doc(3, ["cat", "zebra"])
        table = learning.build_unigram_table(np.arange(1, 40), table_size=4096)
        return (idx.documents("cat"), idx.documents("zebra"),
                idx.num_documents(), idx.total_words(),
                [int(i) for i in idx.sample_docs(5, seed=2)],
                list(idx.batches(7))[-1], table.tobytes())

    assert trace(t_nlp, t_learning) == trace(j_nlp, j_learning)


@pytest.mark.parametrize("kind", ["BagOfWordsVectorizer", "TfidfVectorizer"])
def test_vectorizers_are_the_references(kind):
    texts = [" ".join(s) for s in corpus(20)]

    def trace(m):
        docs = [m.LabelledDocument(t, ["animal" if "cat" in t else "other"])
                for t in texts]
        vec = getattr(m, kind)(min_word_frequency=2, stop_words=["tail"])
        ds = vec.fit_transform(m.SimpleLabelAwareIterator(docs))
        one = vec.vectorize(texts[0], "other")
        return (sorted(vec.vocab.items()), ds.features.tobytes(),
                ds.labels.tobytes(), ds.features.shape,
                one.features.tobytes(), one.labels.tobytes())

    assert trace(t_nlp) == trace(j_nlp)


# ----------------------------------------------------------------------
# single steps
# ----------------------------------------------------------------------

V, D, B, K, W, L = 500, 32, 1024, 5, 6, 9


def step_batch(seed=0):
    """A batch with heavy row collisions: 20 distinct centers, targets,
    negatives and contexts over 60 rows."""
    rng = np.random.default_rng(seed)
    return {"center": rng.integers(0, 20, B).astype(np.int32),
            "target": rng.integers(0, 60, B).astype(np.int32),
            "negs": rng.integers(0, 60, (B, K)).astype(np.int32),
            "ctx": rng.integers(0, 60, (B, W)).astype(np.int32),
            "ctx_mask": (rng.random((B, W)) < 0.7).astype(np.float32),
            "codes": rng.integers(0, 2, (B, L)).astype(np.int32),
            "points": rng.integers(0, 30, (B, L)).astype(np.int32),
            "code_mask": (np.arange(L)[None, :]
                          < rng.integers(1, L + 1, B)[:, None]
                          ).astype(np.float32)}


def step_params(seed=1):
    """Tables away from their zero start, so every term is live."""
    rng = np.random.default_rng(seed)
    return {"syn0": (rng.normal(size=(V, D)) * 0.1).astype(np.float32),
            "syn1neg": (rng.normal(size=(V, D)) * 0.1).astype(np.float32),
            "syn1": (rng.normal(size=(V - 1, D)) * 0.1).astype(np.float32)}


def assert_tables_close(j_params, t_params):
    for k, want in j_params.items():
        err = float(np.abs(np.asarray(want) - t_params[k].numpy()).max())
        assert err <= STEP_ATOL, (k, err)


def assert_loss_close(j_loss, t_loss):
    want = np.asarray(j_loss, np.float64)
    got = t_loss.numpy().astype(np.float64)
    assert np.all(np.abs(got - want) <= STEP_RTOL * np.abs(want)), (got, want)


@pytest.mark.parametrize("cbow", [False, True])
@pytest.mark.parametrize("kind", ["ns", "hs"])
def test_step_matches_the_references(kind, cbow):
    b = step_batch()
    tables = ("syn0", "syn1neg") if kind == "ns" else ("syn0", "syn1")
    p0 = {k: v for k, v in step_params().items() if k in tables}
    j_params = {k: jnp.asarray(v) for k, v in p0.items()}
    t_params = t_learning.params_from_numpy(p0, "cpu")
    names = (("center", "target", "negs") if kind == "ns" else
             ("center", "codes", "points", "code_mask")) + ("ctx", "ctx_mask")
    j_step = getattr(j_learning, f"{kind}_step")
    t_step = getattr(t_learning, f"{kind}_step")
    for lr in (0.025, 0.0125):
        j_params, j_loss = j_step(
            j_params, *(jnp.asarray(b[n]) for n in names), jnp.float32(lr),
            cbow=cbow)
        t_params, t_loss = t_step(
            t_params, *t_learning.to_device([b[n] for n in names], "cpu"),
            lr, cbow=cbow)
        assert_tables_close(j_params, t_params)
        assert_loss_close(j_loss, t_loss)
    moved = float(np.abs(t_params["syn0"].numpy() - p0["syn0"]).max())
    assert moved > 100 * STEP_ATOL


@pytest.mark.parametrize("cbow", [False, True])
def test_ns_step_scan_matches_the_references(cbow):
    steps = [step_batch(s) for s in range(3)]
    stack = {n: np.stack([s[n] for s in steps]) for n in steps[0]}
    p0 = {k: v for k, v in step_params().items() if k != "syn1"}
    names = ("center", "target", "negs")
    ctx = ("ctx", "ctx_mask")
    j_params, j_losses = j_learning.ns_step_scan(
        {k: jnp.asarray(v) for k, v in p0.items()},
        *(jnp.asarray(stack[n]) for n in names),
        *((jnp.asarray(stack[n]) for n in ctx) if cbow else (None, None)),
        jnp.float32(0.025), cbow=cbow)
    t_args = t_learning.to_device([stack[n] for n in names + ctx], "cpu")
    t_params, t_losses = t_learning.ns_step_scan(
        t_learning.params_from_numpy(p0, "cpu"), *t_args[:3],
        *(t_args[3:] if cbow else (None, None)), 0.025, cbow=cbow)
    assert t_losses.shape == (3,)
    assert_tables_close(j_params, t_params)
    assert_loss_close(j_losses, t_losses)


def test_init_params_are_the_references():
    j = j_learning.init_params(300, 24, seed=5, hs_nodes=299,
                               extra_vectors=7)
    t = t_learning.init_params(300, 24, seed=5, hs_nodes=299,
                               extra_vectors=7, device="cpu")
    assert sorted(j) == sorted(t)
    for k in j:
        assert np.asarray(j[k]).tobytes() == t[k].numpy().tobytes(), k


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_nlp.SequenceVectors(layer_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_learning.init_params(10, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_nlp.Word2Vec.builder().layer_size(8).build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_nlp.Glove(layer_size=8)


# ----------------------------------------------------------------------
# whole seeded runs
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def w2v_runs():
    """Seeded fits through each package: negative sampling (skip-gram,
    subsampling on), HS, and CBOW through the builder."""
    seqs = corpus(150)
    sentences = [" ".join(s) for s in seqs]
    kw = {"ns": dict(layer_size=16, window=3, negative=5, epochs=2, seed=1,
                     batch_size=256, sample=1e-2),
          "hs": dict(layer_size=16, window=3, negative=0, epochs=2, seed=2,
                     batch_size=256)}
    out = {}
    for name, k in kw.items():
        out[name] = (j_nlp.SequenceVectors(**k).fit(seqs),
                     t_nlp.SequenceVectors(**k, device="cpu").fit(seqs))

    def built(m, device=None):
        b = (m.Word2Vec.builder().layer_size(12).window_size(2)
             .negative_sample(3).epochs(2).seed(3).batch_size(128)
             .use_cbow().iterate(m.CollectionSentenceIterator(sentences))
             .tokenizer_factory(m.DefaultTokenizerFactory()))
        if device is not None:
            b = b.device(device)
        return b.build().fit()

    out["cbow_builder"] = (built(j_nlp), built(t_nlp, "cpu"))
    return out


@pytest.mark.parametrize("name", ["ns", "hs", "cbow_builder"])
def test_word2vec_fit_matches_the_references(w2v_runs, name):
    j_model, t_model = w2v_runs[name]
    assert t_model.vocab.words() == j_model.vocab.words()
    assert syn0_err(j_model, t_model) <= FIT_ATOL
    for a, b in (("cat", "dog"), ("cat", "car"), ("road", "wheel")):
        assert abs(t_model.similarity(a, b)
                   - j_model.similarity(a, b)) <= FIT_ATOL
    moved = np.abs(t_model._syn0()).max()
    assert moved > 0.5 / t_model.layer_size        # trained past its init


def test_reference_tables_carried_across_give_the_same_lookups(w2v_runs):
    j_model, _ = w2v_runs["ns"]
    sv = t_nlp.SequenceVectors(layer_size=16, device="cpu")
    sv.vocab = j_model.vocab
    sv.params = t_learning.params_from_numpy(
        {k: np.asarray(v) for k, v in j_model.params.items()}, "cpu")
    for a, b in (("cat", "dog"), ("car", "tail")):
        assert sv.similarity(a, b) == j_model.similarity(a, b)
    assert sv.words_nearest("cat", 5) == j_model.words_nearest("cat", 5)
    vec = j_model.get_word_vector("road")
    assert sv.words_nearest(vec, 4) == j_model.words_nearest(vec, 4)
    assert sv.get_word_vector("road").tobytes() == vec.tobytes()


def docs(n=40, seed=0):
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "pet", "fur", "tail"] + \
        [f"animal{i}" for i in range(15)]
    vehicles = ["car", "road", "wheel", "drive", "engine"] + \
        [f"vehicle{i}" for i in range(15)]
    return [(f"{'animal' if i % 2 == 0 else 'vehicle'}_{i}",
             list(rng.choice(animals if i % 2 == 0 else vehicles, size=12)))
            for i in range(n)]


@pytest.mark.parametrize("dm", [False, True])
def test_paragraph_vectors_match_the_references(dm):
    d = docs()
    kw = dict(layer_size=16, window=3, epochs=6, seed=6, dm=dm,
              batch_size=128)
    j_pv = j_nlp.ParagraphVectors(**kw).fit_documents(d)
    t_pv = t_nlp.ParagraphVectors(**kw, device="cpu").fit_documents(d)
    assert syn0_err(j_pv, t_pv) <= FIT_ATOL
    for label in ("animal_0", "vehicle_1"):
        err = np.abs(t_pv.get_paragraph_vector(label)
                     - np.asarray(j_pv.get_paragraph_vector(label))).max()
        assert err <= FIT_ATOL, (label, err)
    words = ["cat", "dog", "pet", "fur"]
    j_vec = j_pv.infer_vector(words, steps=10, seed=3)
    t_vec = t_pv.infer_vector(words, steps=10, seed=3)
    assert np.abs(t_vec - j_vec).max() <= FIT_ATOL
    assert np.abs(t_vec - j_vec).max() < 0.1 * np.abs(j_vec).max()
    assert t_pv.nearest_labels(t_vec, 5) == j_pv.nearest_labels(j_vec, 5)


def test_glove_fit_matches_the_references():
    seqs = corpus(60)
    kw = dict(layer_size=12, window=3, epochs=8, seed=8, learning_rate=0.05,
              batch_size=256)
    j_gl = j_nlp.Glove(**kw).fit(seqs)
    t_gl = t_nlp.Glove(**kw, device="cpu").fit(seqs)
    assert syn0_err(j_gl, t_gl) <= FIT_ATOL
    for k in ("w", "w_tilde", "b", "b_tilde"):
        err = np.abs(np.asarray(j_gl._accum[k])
                     - t_gl._accum[k].numpy()).max()
        assert err <= FIT_ATOL * np.abs(np.asarray(j_gl._accum[k])).max(), k
    assert abs(t_gl.similarity("cat", "dog")
               - j_gl.similarity("cat", "dog")) <= FIT_ATOL
    with pytest.raises(ValueError):
        t_nlp.Glove(layer_size=8, device="cpu").fit([[]])


# ----------------------------------------------------------------------
# the word-vector files
# ----------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["txt", "bin", "bin.gz"])
def test_vector_files_cross_both_ways_bitwise(w2v_runs, tmp_path, fmt):
    j_model, t_model = w2v_runs["ns"]
    J, T = j_nlp.WordVectorSerializer, t_nlp.WordVectorSerializer
    write = ("write_word_vectors" if fmt == "txt"
             else "write_word_vectors_binary")
    binary = fmt != "txt"
    jp, tp = str(tmp_path / f"j.{fmt}"), str(tmp_path / f"t.{fmt}")
    getattr(J, write)(j_model, jp)
    getattr(T, write)(t_model, tp)
    # each file loads into both packages alike (the loaders' vocabulary
    # order is their own sort, the same in both)
    for path, model in ((jp, j_model), (tp, t_model)):
        j_load = J.load_google_model(path, binary=binary)
        t_load = T.load_google_model(path, binary=binary, device="cpu")
        assert t_load.vocab.words() == j_load.vocab.words()
        assert t_load._syn0().tobytes() == np.asarray(
            j_load._syn0()).tobytes()
        if binary:       # exact f32 in the file: every vector as trained
            for w in model.vocab.words():
                assert (t_load.get_word_vector(w).tobytes()
                        == np.asarray(model.get_word_vector(w)).tobytes()), w
    # the same tables give the same file, byte for byte
    same = t_nlp.SequenceVectors(layer_size=j_model.layer_size,
                                 device="cpu")
    same.vocab = j_model.vocab
    same.params = t_learning.params_from_numpy(
        {"syn0": np.asarray(j_model.params["syn0"])}, "cpu")
    sp = str(tmp_path / f"same.{fmt}")
    getattr(T, write)(same, sp)
    import gzip
    opener = gzip.open if fmt.endswith(".gz") else open
    with opener(sp, "rb") as a, opener(jp, "rb") as b:
        assert a.read() == b.read()


def test_binary_writer_refuses_whitespace_tokens(tmp_path):
    seqs = corpus(20) + [["bad token", "cat", "dog"] * 3]
    sv = t_nlp.SequenceVectors(layer_size=8, epochs=1, seed=9,
                               device="cpu").fit(seqs)
    with pytest.raises(ValueError, match="whitespace"):
        t_nlp.WordVectorSerializer.write_word_vectors_binary(
            sv, str(tmp_path / "v.bin"))
