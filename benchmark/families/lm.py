"""The decoder-only LM family: how a configuration file becomes the
program's ``transformer_lm(input_ids=True)``, its weights from the seed,
and the plain reference that judges it."""

from __future__ import annotations

from reference import lm as ref

# rows are independent, so the reference takes a batch two rows at a time
REFERENCE_ROWS = 2


def port_conf(cfg: dict):
    """``transformer_lm`` at the configuration's sizes, with each attention
    block's output linear, as OPT's is: the builder's default activation
    would put a sigmoid there."""
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    t = cfg["training"]
    conf = transformer_lm(
        cfg["vocab_size"], n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        d_ff=cfg["ffn_dim"], updater=t["updater"],
        learning_rate=t["learning_rate"], dtype=cfg["program"]["dtype"],
        input_ids=True)
    for i in range(cfg["num_hidden_layers"]):
        conf.vertices[f"blk{i}_attn"].layer.activation = "identity"
    return conf


def init(cfg: dict, vertex: str, name: str, shape):
    """How a leaf starts: N(0, init_std) for every matrix and the
    embedding (the std returned), zero biases, LayerNorm gamma 1, beta 0."""
    if name == "gamma":
        return "ones"
    if name in ("b", "beta"):
        return "zeros"
    return float(cfg["init_std"])


logits = ref.logits
summed_loss = ref.summed_loss
