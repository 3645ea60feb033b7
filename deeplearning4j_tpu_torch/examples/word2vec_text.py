"""Word2Vec skip-gram with negative sampling over a sentence source
(counterpart of the JAX package's ``examples/word2vec_text.py``).

DL4J analog: `Word2VecRawTextExample` — builder, tokenizer factory,
`wordsNearest`, and text-format serialization round-trip.

Run: python -m deeplearning4j_tpu_torch.examples.word2vec_text [--smoke] [--device cpu]
"""
import os
import tempfile

from deeplearning4j_tpu_torch.examples._cli import run
from deeplearning4j_tpu_torch.nlp.sentence_iterator import \
    CollectionSentenceIterator
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.word2vec import (Word2Vec,
                                                   WordVectorSerializer)

SENTENCES = [
    "the day was bright and the night was dark",
    "day follows night and night follows day",
    "a bright morning is the start of the day",
    "the dark evening is the start of the night",
    "cats and dogs are animals",
    "dogs chase cats and cats chase mice",
] * 40


def main(smoke: bool = False, device="cuda"):
    w2v = (Word2Vec.builder()
           .layer_size(16 if smoke else 100)
           .window_size(3).min_word_frequency(2)
           .negative_sample(5)
           .epochs(1 if smoke else 5)
           .seed(42)
           .iterate(CollectionSentenceIterator(SENTENCES))
           .tokenizer_factory(DefaultTokenizerFactory())
           .device(device)
           .build())
    w2v.fit()
    print("nearest to 'day':", w2v.words_nearest("day", top=5))

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "vectors.txt")
        WordVectorSerializer.write_word_vectors(w2v, path)
        restored = WordVectorSerializer.load_txt_vectors(path, device=device)
    print("vocab round-trips:",
          restored.vocab.num_words() == w2v.vocab.num_words())


if __name__ == "__main__":
    run(main, __doc__)
