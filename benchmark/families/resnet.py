"""The bottleneck ResNet family: how a configuration file becomes the
program's ``models.resnet.resnet``, its weights from the seed, and the
plain reference that judges it."""

from __future__ import annotations

import math

from reference import resnet as ref

# BatchNorm couples the rows of a batch: the reference takes it whole
REFERENCE_ROWS = None


def port_conf(cfg: dict):
    from deeplearning4j_tpu_torch.models.resnet import resnet
    t = cfg["training"]
    if (cfg["stem_kernel"], cfg["stem_stride"]) != (7, 2):
        raise ValueError("the program's resnet has the 7x7/2 stem only")
    widths = [h // cfg["expansion"] for h in cfg["hidden_sizes"]]
    if widths != [cfg["embedding_size"] * 2 ** i for i in range(len(widths))]:
        raise ValueError("the program's resnet doubles its width per stage")
    return resnet(tuple(cfg["depths"]), height=cfg["image_size"],
                  width=cfg["image_size"], channels=cfg["num_channels"],
                  n_classes=cfg["num_labels"],
                  width_base=cfg["embedding_size"], updater=t["updater"],
                  learning_rate=t["learning_rate"], momentum=t["momentum"],
                  dtype=cfg["program"]["dtype"], stem="conv7")


def init(cfg: dict, vertex: str, name: str, shape):
    """How a leaf starts: He-normal weights (the std returned; fan-in over
    an HWIO conv's or an [in, out] dense weight's leading axes), zero
    biases, BatchNorm gamma 1, beta 0."""
    if name == "gamma":
        return "ones"
    if name in ("b", "beta"):
        return "zeros"
    return math.sqrt(2.0 / math.prod(shape[:-1]))


logits = ref.logits
summed_loss = ref.summed_loss
