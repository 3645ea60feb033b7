"""Model zoo: canonical configurations (this slice: the transformer LM)."""

from .transformer import transformer_lm

__all__ = ["transformer_lm"]
