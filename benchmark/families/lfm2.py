"""The hybrid conv/attention MoE LM family (LFM2-MoE): how a configuration
file becomes the program's ``lfm2_moe_lm``, its weights
from the seed, and the plain reference that judges it.

The reference's selection biases are state that moves after each step:
:func:`logits` keeps them for the parameter tree it is given (keyed
weakly by the tree's first router, so a new tree starts from zero) and
moves them by the loads of each call. So the reference takes a batch
whole, one call a step."""

from __future__ import annotations

from torch.utils.weak import WeakIdKeyDictionary

from reference import lfm2 as ref

REFERENCE_ROWS = None

_BIASES = WeakIdKeyDictionary()


def port_conf(cfg: dict):
    """``lfm2_moe_lm`` at the configuration's sizes: its first
    ``num_hidden_layers`` layer types, and in every MoE layer the
    ``num_experts`` experts this chip holds of the deployment's
    ``routed_experts``."""
    from deeplearning4j_tpu_torch.models.lfm2 import lfm2_moe_lm
    t, dep = cfg["training"], cfg["deployment"]
    n = cfg["num_hidden_layers"]
    return lfm2_moe_lm(
        cfg["vocab_size"], layer_types=cfg["layer_types"][:n],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], moe_d_ff=cfg["moe_intermediate_size"],
        n_experts=dep["routed_experts"], top_k=cfg["num_experts_per_tok"],
        experts_held=cfg["num_experts"], first_expert=dep["first_expert"],
        num_dense_layers=cfg["num_dense_layers"], conv_L=cfg["conv_L_cache"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["norm_eps"],
        routed_scaling=float(cfg["routed_scaling_factor"]),
        bias_update_rate=t["expert_bias_update_rate"],
        updater=t["updater"], learning_rate=t["learning_rate"],
        dtype=cfg["program"]["dtype"])


def init(cfg: dict, vertex: str, name: str, shape):
    """How a leaf starts: the RMSNorm weights at 1, the head's bias at 0,
    every other leaf (matrices, experts, conv filters, the embedding)
    N(0, init_std)."""
    if name in ("gamma", "q_norm", "k_norm"):
        return "ones"
    if name == "b":
        return "zeros"
    return float(cfg["init_std"])


def logits(params, ids, cfg, ar):
    """The reference's logits of one step's batch, under the biases this
    tree's earlier calls left, which then move by this call's loads."""
    key = params[ref.moe_vertices(cfg)[0]]["router"]
    biases = _BIASES.get(key)
    if biases is None:
        biases = ref.zero_biases(cfg, key.device)
    out, loads = ref.logits(params, ids, cfg, ar, biases)
    _BIASES[key] = ref.next_biases(biases, loads, cfg)
    return out


summed_loss = ref.summed_loss
