"""Tokenization (a copy of the JAX package's ``nlp/tokenization.py``,
host code; parity: reference ``text/tokenization/`` —
``DefaultTokenizer``, ``NGramTokenizer``, ``tokenizerfactory/``,
``CommonPreprocessor``/``EndingPreProcessor``)."""

from __future__ import annotations

import re
from typing import Callable, List, Optional


class TokenPreProcess:
    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits-adjacent junk (parity:
    ``CommonPreprocessor.java``)."""

    _PUNCT = re.compile(r"[\d.:,\"'()\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token.lower())


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token: str) -> str:
        return token.lower()


class EndingPreProcessor(TokenPreProcess):
    """Crude stemmer dropping common English endings (parity:
    ``EndingPreProcessor.java``)."""

    def pre_process(self, token: str) -> str:
        for ending in ("sses", "ies", "ing", "ed", "s"):
            if token.endswith(ending) and len(token) > len(ending) + 2:
                return token[: -len(ending)]
        return token


class Tokenizer:
    def get_tokens(self) -> List[str]:
        raise NotImplementedError


class DefaultTokenizer(Tokenizer):
    """Whitespace tokenizer with optional per-token preprocessing."""

    def __init__(self, text: str,
                 preprocessor: Optional[TokenPreProcess] = None):
        self.text = text
        self.preprocessor = preprocessor

    def get_tokens(self) -> List[str]:
        tokens = self.text.split()
        if self.preprocessor is not None:
            tokens = [self.preprocessor.pre_process(t) for t in tokens]
        return [t for t in tokens if t]


class NGramTokenizer(Tokenizer):
    """Emits n-grams (joined by '_') over the base tokens (parity:
    ``NGramTokenizer.java``)."""

    def __init__(self, base: Tokenizer, min_n: int, max_n: int):
        self.base = base
        self.min_n, self.max_n = int(min_n), int(max_n)

    def get_tokens(self) -> List[str]:
        toks = self.base.get_tokens()
        out: List[str] = []
        for n in range(self.min_n, self.max_n + 1):
            if n == 1:
                out.extend(toks)
            else:
                out.extend("_".join(toks[i:i + n])
                           for i in range(len(toks) - n + 1))
        return out


class TokenizerFactory:
    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self.preprocessor = pre


class DefaultTokenizerFactory(TokenizerFactory):
    def __init__(self, preprocessor: Optional[TokenPreProcess] = None):
        self.preprocessor = preprocessor

    def create(self, text: str) -> Tokenizer:
        return DefaultTokenizer(text, self.preprocessor)


class NGramTokenizerFactory(TokenizerFactory):
    def __init__(self, min_n: int = 1, max_n: int = 2,
                 preprocessor: Optional[TokenPreProcess] = None):
        self.min_n, self.max_n = min_n, max_n
        self.preprocessor = preprocessor

    def create(self, text: str) -> Tokenizer:
        return NGramTokenizer(DefaultTokenizer(text, self.preprocessor),
                              self.min_n, self.max_n)
