"""MultiLayerConfiguration: the ordered layer stack, its input
preprocessors, training fields and serde (counterpart of the JAX package's
``nn/conf/multi_layer.py``; the same JSON and YAML). TBPTT lengths default
to 20.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from .inputs import InputType
from .layers import Layer, layer_from_dict, layer_to_dict
from .preprocessors import InputPreProcessor, preprocessor_from_dict
from .training import TrainingConfig

# register the recurrent, attention, MoE and pretrain layer types the JSON
# may name
from . import attention as _attention  # noqa: F401
from . import hybrid as _hybrid  # noqa: F401
from . import moe as _moe  # noqa: F401
from . import pretrain as _pretrain  # noqa: F401
from . import recurrent as _recurrent  # noqa: F401


@dataclasses.dataclass
class MultiLayerConfiguration:
    layers: List[Layer]
    input_preprocessors: Dict[int, InputPreProcessor] = dataclasses.field(default_factory=dict)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    input_type: Optional[InputType] = None
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20

    # ---- serde ----
    def to_dict(self) -> dict:
        return {
            "format_version": 1,
            "framework": "deeplearning4j_tpu",
            "layers": [layer_to_dict(l) for l in self.layers],
            "input_preprocessors": {str(i): p.to_dict()
                                    for i, p in self.input_preprocessors.items()},
            "training": self.training.to_dict(),
            "input_type": self.input_type.to_dict() if self.input_type else None,
            "backprop": self.backprop,
            "pretrain": self.pretrain,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
        }

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration(
            layers=[layer_from_dict(l) for l in d["layers"]],
            input_preprocessors={int(i): preprocessor_from_dict(p)
                                 for i, p in d.get("input_preprocessors", {}).items()},
            training=TrainingConfig.from_dict(d.get("training", {})),
            input_type=(InputType.from_dict(d["input_type"])
                        if d.get("input_type") else None),
            backprop=d.get("backprop", True),
            pretrain=d.get("pretrain", False),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
        )

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))

    def to_yaml(self) -> str:
        import yaml
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    @staticmethod
    def from_yaml(s: str) -> "MultiLayerConfiguration":
        import yaml
        return MultiLayerConfiguration.from_dict(yaml.safe_load(s))

    # ---- convenience ----
    def n_layers(self) -> int:
        return len(self.layers)

    def layer_input_types(self) -> List[InputType]:
        """Per-layer post-preprocessor input types (requires input_type)."""
        if self.input_type is None:
            raise ValueError("input_type not set on this configuration")
        out = []
        cur = self.input_type
        for i, layer in enumerate(self.layers):
            proc = self.input_preprocessors.get(i)
            if proc is not None:
                cur = proc.output_type(cur)
            out.append(cur)
            cur = layer.output_type(cur)
        return out
