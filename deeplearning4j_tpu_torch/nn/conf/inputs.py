"""Input types for shape inference (counterpart of the JAX package's
``nn/conf/inputs.py``; the same fields and JSON).

Image tensors are NHWC here as in the reference, so
``InputType.convolutional(height, width, channels)`` describes
``[batch, height, width, channels]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class InputType:
    kind: str  # "feedforward" | "recurrent" | "convolutional" | "convolutional_flat"
    size: int = 0               # feedforward/recurrent feature size
    timesteps: Optional[int] = None  # recurrent (None = variable)
    height: int = 0
    width: int = 0
    channels: int = 0

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType(kind="feedforward", size=size)

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "InputType":
        return InputType(kind="recurrent", size=size, timesteps=timesteps)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType(kind="convolutional", height=height, width=width,
                         channels=channels)

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int) -> "InputType":
        return InputType(kind="convolutional_flat", size=height * width * channels,
                         height=height, width=width, channels=channels)

    def flat_size(self) -> int:
        if self.kind in ("feedforward", "recurrent", "convolutional_flat"):
            return self.size
        return self.height * self.width * self.channels

    def to_dict(self):
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v not in (None, 0) or k == "kind"}

    @staticmethod
    def from_dict(d) -> "InputType":
        return InputType(**{k: d.get(k, InputType.__dataclass_fields__[k].default)
                            for k in InputType.__dataclass_fields__})
