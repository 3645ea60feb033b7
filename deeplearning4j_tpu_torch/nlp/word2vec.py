"""Word2Vec: the user-facing builder over SequenceVectors + serde
(counterpart of the JAX package's ``nlp/word2vec.py``; the files either
package writes load into the other with vectors bitwise equal).

Parity: reference ``models/word2vec/Word2Vec.java`` (builder:
``layerSize/windowSize/minWordFrequency/negativeSample/iterations/epochs/
sampling/learningRate/minLearningRate/seed/iterate/tokenizerFactory``) and
``loader/WordVectorSerializer.java`` (word2vec text format read/write).
"""

from __future__ import annotations

import gzip
from typing import List, Optional

import numpy as np

from .learning import params_from_numpy
from .sequence_vectors import SequenceVectors
from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabCache


class Word2Vec(SequenceVectors):
    """Word embeddings from a sentence source.

    Usage (mirrors the reference builder)::

        w2v = (Word2Vec.builder()
               .layer_size(100).window_size(5).min_word_frequency(5)
               .iterate(sentence_iterator)
               .tokenizer_factory(DefaultTokenizerFactory())
               .device("cuda")
               .build())
        w2v.fit()
        w2v.words_nearest("day")
    """

    def __init__(self, sentence_iterator=None,
                 tokenizer_factory: Optional[TokenizerFactory] = None, **kw):
        super().__init__(**kw)
        self.sentence_iterator = sentence_iterator
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()

    # -- builder (fluent, reference-style) --
    class Builder:
        def __init__(self):
            self._kw = {}
            self._iter = None
            self._tok = None

        def layer_size(self, n): self._kw["layer_size"] = int(n); return self
        def window_size(self, n): self._kw["window"] = int(n); return self
        def min_word_frequency(self, n): self._kw["min_word_frequency"] = int(n); return self
        def negative_sample(self, n): self._kw["negative"] = int(n); return self
        def sampling(self, s): self._kw["sample"] = float(s); return self
        def learning_rate(self, lr): self._kw["learning_rate"] = float(lr); return self
        def min_learning_rate(self, lr): self._kw["min_learning_rate"] = float(lr); return self
        def epochs(self, n): self._kw["epochs"] = int(n); return self
        def iterations(self, n): return self.epochs(n)
        def batch_size(self, n): self._kw["batch_size"] = int(n); return self
        def seed(self, s): self._kw["seed"] = int(s); return self
        def use_cbow(self, flag=True): self._kw["use_cbow"] = bool(flag); return self
        def limit_vocabulary_size(self, n): self._kw["vocab_limit"] = int(n); return self
        def device(self, d): self._kw["device"] = d; return self

        def iterate(self, sentence_iterator): self._iter = sentence_iterator; return self
        def tokenizer_factory(self, tf): self._tok = tf; return self

        def build(self) -> "Word2Vec":
            return Word2Vec(self._iter, self._tok, **self._kw)

    @staticmethod
    def builder() -> "Word2Vec.Builder":
        return Word2Vec.Builder()

    # -- fit from the configured sentence source --
    def _token_sequences(self) -> List[List[str]]:
        if self.sentence_iterator is None:
            raise ValueError("no sentence iterator configured (builder.iterate)")
        return [self.tokenizer_factory.create(s).get_tokens()
                for s in self.sentence_iterator]

    def fit(self, sequences=None, resettable: bool = True) -> "Word2Vec":
        if sequences is None:
            sequences = self._token_sequences()
        else:
            # Raw sentence strings go through the tokenizer factory, same as
            # the configured sentence source (ref SentenceTransformer.java).
            sequences = [self.tokenizer_factory.create(s).get_tokens()
                         if isinstance(s, str) else s
                         for s in sequences]
        super().fit(sequences, resettable)
        return self


class WordVectorSerializer:
    """word2vec text-format read/write (parity:
    ``WordVectorSerializer.writeWordVectors/loadTxtVectors``)."""

    @staticmethod
    def write_word_vectors(model: SequenceVectors, path: str) -> None:
        opener = gzip.open if path.endswith(".gz") else open
        syn0 = model._syn0()
        with opener(path, "wt", encoding="utf-8") as f:
            f.write(f"{model.vocab.num_words()} {model.layer_size}\n")
            for i, word in enumerate(model.vocab.words()):
                vec = " ".join(f"{v:.6f}" for v in syn0[i])
                f.write(f"{word} {vec}\n")

    @staticmethod
    def write_word_vectors_binary(model: SequenceVectors, path: str) -> None:
        """Google word2vec C binary format write (parity:
        ``WordVectorSerializer.writeWordVectors`` binary branch): ASCII
        header ``"<n_words> <dim>\\n"``, then per word the UTF-8 word bytes,
        a space, ``dim`` little-endian float32s, and a newline — the layout
        the original word2vec C tool emits and the ecosystem interchanges."""
        opener = gzip.open if path.endswith(".gz") else open
        syn0 = np.asarray(model._syn0(), dtype="<f4")
        # the format's only word terminator is a single space, so any
        # whitespace inside a token desynchronizes every reader (ours and
        # the ecosystem's) from the first such word on — refuse at write
        # time instead of emitting a corrupt file
        for word in model.vocab.words():
            if word != word.strip() or any(ch.isspace() for ch in word):
                raise ValueError(
                    f"vocab word {word!r} contains whitespace — the "
                    "word2vec C binary format cannot represent it; clean "
                    "the tokenization before writing binary vectors")
        with opener(path, "wb") as f:
            f.write(f"{model.vocab.num_words()} {model.layer_size}\n"
                    .encode("utf-8"))
            for i, word in enumerate(model.vocab.words()):
                f.write(word.encode("utf-8") + b" ")
                f.write(syn0[i].tobytes())
                f.write(b"\n")

    @staticmethod
    def load_google_model(path: str, binary: bool = True,
                          device="cuda") -> SequenceVectors:
        """Load a Google-format word2vec model (parity:
        ``WordVectorSerializer.java:109-152`` ``loadGoogleModel``): binary
        (word2vec C ``fwrite`` float32 layout) or text; the vectors go to
        ``device``."""
        if not binary:
            return WordVectorSerializer.load_txt_vectors(path, device)
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            header = f.readline().decode("utf-8").split()
            n_words, dim = int(header[0]), int(header[1])
            vec_bytes = dim * 4
            words, vecs = [], []
            for _ in range(n_words):
                # word bytes run to the separating space (skip leading
                # newlines some writers leave after the previous vector)
                chars = []
                while True:
                    ch = f.read(1)
                    if not ch:
                        raise ValueError(
                            f"truncated binary model: read {len(words)} of "
                            f"{n_words} words")
                    if ch == b" ":
                        break
                    if ch != b"\n":
                        chars.append(ch)
                words.append(b"".join(chars).decode("utf-8"))
                buf = f.read(vec_bytes)
                if len(buf) != vec_bytes:
                    raise ValueError(
                        f"truncated vector for word {words[-1]!r}")
                vecs.append(np.frombuffer(buf, dtype="<f4").copy())
        return WordVectorSerializer._from_words_vecs(words, vecs, dim, device)

    @staticmethod
    def _from_words_vecs(words, vecs, dim, device) -> SequenceVectors:
        model = SequenceVectors(layer_size=dim, device=device)
        vocab = VocabCache()
        for w in words:
            vocab.add_token(w)
        vocab.finalize()
        # finalize() sorts by (count desc, word) — re-map to file order
        order = [vocab.index_of(w) for w in words]
        syn0 = np.zeros((len(words), dim), dtype=np.float32)
        for src, dst in enumerate(order):
            syn0[dst] = vecs[src]
        model.vocab = vocab
        model.params = params_from_numpy({"syn0": syn0}, model.device)
        return model

    @staticmethod
    def load_txt_vectors(path: str, device="cuda") -> SequenceVectors:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            header = f.readline().split()
            n_words, dim = int(header[0]), int(header[1])
            words, vecs = [], []
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < dim + 1:
                    continue
                words.append(parts[0])
                vecs.append(np.asarray(parts[1:dim + 1], dtype=np.float32))
        return WordVectorSerializer._from_words_vecs(words, vecs, dim, device)
