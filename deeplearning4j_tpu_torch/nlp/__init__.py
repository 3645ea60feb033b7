"""NLP / embeddings stack (counterpart of the JAX package's ``nlp/``).

Parity: reference ``deeplearning4j-nlp-parent`` (~34k LoC) —
``SequenceVectors.java:161`` (the generic embedding trainer),
``SkipGram.java:216`` / ``CBOW.java`` (learning algorithms), ``Word2Vec``,
``ParagraphVectors`` (``inferVector``), ``Glove``, vocab
(``AbstractCache``, ``VocabConstructor``), Huffman tree, tokenization +
sentence iterators, and ``WordVectorSerializer`` formats.

As in the JAX package, the reference's lock-free multithreaded per-word
gemv updates (Hogwild, ``SequenceVectors.java:245-260``) become host-side
index batches — (center, context/code-path, negatives) int arrays, drawn
by the JAX package's numpy code verbatim — and ONE vectorized step per
batch on the device: ``index_select`` gathers, sigmoid-dot losses and
their gradients in closed form, sorted scatter-adds (``learning.py``).
Negative sampling and hierarchical softmax are both expressed this way.
Everything that holds tables takes ``device`` (``"cuda"`` by default).
"""

from .documents import (
    AsyncLabelAwareIterator, BasicLabelAwareIterator, FileDocumentIterator,
    FileLabelAwareIterator, FilenamesLabelAwareIterator, LabelAwareIterator,
    LabelledDocument, LabelsSource, SimpleLabelAwareIterator)
from .glove import Glove
from .inverted_index import InvertedIndex
from .paragraph_vectors import ParagraphVectors
from .sentence_iterator import (
    BasicLineIterator, CollectionSentenceIterator, FileSentenceIterator,
    SentenceIterator)
from .sequence_vectors import SequenceVectors
from .tokenization import (
    DefaultTokenizer, DefaultTokenizerFactory, NGramTokenizerFactory,
    CommonPreprocessor)
from .vectorizers import BagOfWordsVectorizer, TextVectorizer, TfidfVectorizer
from .vocab import Huffman, VocabCache, VocabWord
from .word2vec import Word2Vec, WordVectorSerializer

__all__ = [
    "Word2Vec", "ParagraphVectors", "Glove", "SequenceVectors",
    "VocabCache", "VocabWord", "Huffman",
    "DefaultTokenizer", "DefaultTokenizerFactory", "NGramTokenizerFactory",
    "CommonPreprocessor",
    "SentenceIterator", "BasicLineIterator", "CollectionSentenceIterator",
    "FileSentenceIterator",
    "WordVectorSerializer",
    "LabelledDocument", "LabelsSource", "LabelAwareIterator",
    "SimpleLabelAwareIterator", "BasicLabelAwareIterator",
    "FileLabelAwareIterator", "FilenamesLabelAwareIterator",
    "AsyncLabelAwareIterator", "FileDocumentIterator",
    "BagOfWordsVectorizer", "TfidfVectorizer", "TextVectorizer",
    "InvertedIndex",
]
