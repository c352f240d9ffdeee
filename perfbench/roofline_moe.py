"""The yardstick's arithmetic for the ``audio_lm`` configurations: the
routed experts' bytes and operations from the program's expert-load counts,
their least time by ``roofline.bound``, and the model FLOPs of a decoded
window counted with the active parameters.

The expert product is counted as the work the routing asks for, whatever
implements it: per MoE-layer call, the weights (gate, up and down) of each
expert that got a pair read once, each token's row read once, the
intermediate rows written and read once, the output rows written once in
float32; two operations a multiply-add of the pairs' three products. The
counts are summed per phase (prefill, decode), and each phase's calls are
bound by one resource alike: a decode step's few rows an expert by the
bytes, a prefill's hundreds by the operations. Model FLOPs count two
operations a multiply-add, the latent attention in its plain form (keys and
values made once a token), the routed experts that each token uses and the
logits of the positions whose logits are read."""

from __future__ import annotations

from typing import Dict

from . import roofline

PROMPT = 3      # the prompt's ids after the audio positions


def expert_weight_bytes(m: dict, item: int) -> int:
    """One routed expert's gate, up and down matrices."""
    return 3 * m["hidden_size"] * m["moe_intermediate_size"] * item


def moe_bytes(m: dict, routed: int, experts: int, item: int = 2) -> float:
    """``routed`` (token, expert) pairs over ``experts`` (layer, expert)
    pairs that got any: the weights read, the tokens' rows in, the
    intermediate rows out and in again, the float32 output rows."""
    d, f = m["hidden_size"], m["moe_intermediate_size"]
    tokens = routed / m["num_experts_per_tok"]
    return (experts * expert_weight_bytes(m, item) + tokens * d * item
            + 2 * routed * f * item + routed * d * 4)


def moe_flops(m: dict, routed: int) -> float:
    return 2.0 * 3 * routed * m["hidden_size"] * m["moe_intermediate_size"]


def moe_bound_ms(m: dict, counts: Dict[str, int]) -> float:
    """The least time of the expert products behind ``counts`` (the
    program's ``routed_*`` / ``experts_*`` counts of the prefill and decode
    phases), in ms."""
    dtype = m["compute_dtype"]
    total = 0.0
    for phase in ("prefill", "decode"):
        routed = counts.get(f"routed_{phase}", 0)
        if routed:
            total += roofline.bound(
                moe_bytes(m, routed, counts.get(f"experts_{phase}", 0),
                          roofline.ITEM[dtype]),
                moe_flops(m, routed), dtype)[0]
    return total


def lm_flops(m: dict, tokens: int, keys: int) -> float:
    """``tokens`` positions through the LM's layers, attending to ``keys``
    keys in all (summed over the tokens), without the logits."""
    d, h = m["hidden_size"], m["num_attention_heads"]
    r, dr = m["kv_lora_rank"], m["qk_rope_head_dim"]
    dn, dv = m["qk_nope_head_dim"], m["v_head_dim"]
    layers, dense = m["num_hidden_layers"], m["first_k_dense_replace"]
    proj = d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) + h * dv * d
    mlp_dense = 3 * d * m["intermediate_size"]
    f = m["moe_intermediate_size"]
    mlp_moe = (d * m["n_routed_experts"]
               + m["num_experts_per_tok"] * 3 * d * f
               + 3 * d * f * m["n_shared_experts"])
    macs = tokens * (layers * proj + dense * mlp_dense
                     + (layers - dense) * mlp_moe)
    macs += layers * keys * h * (dn + dr + dv)
    return 2.0 * macs


def head_flops(m: dict) -> float:
    return 2.0 * m["hidden_size"] * m["vocab_size"]


def decoded_window_flops(m: dict, columns: int, fed: int, rows: int) -> float:
    """A window's prefix (S = columns // 2 projected encoder states and the
    prompt, causal, with the logits of its last position) once, then
    ``rows`` beams that each fed ``fed`` generated tokens (each with its
    logits), the j-th attending to the prefix and j + 1 generated keys."""
    p = columns // 2 + PROMPT
    prefix = (2.0 * (columns // 2) * m["d_model"] * m["hidden_size"]
              + lm_flops(m, p, p * (p + 1) // 2) + head_flops(m))
    keys = fed * p + fed * (fed + 1) // 2
    return prefix + rows * (lm_flops(m, fed, keys) + fed * head_flops(m))
