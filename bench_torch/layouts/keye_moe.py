"""Keye-VL-2.0's text stack (Qwen3-MoE's block): GQA attention with no
bias and an RMSNorm over each q and k head, and in every layer a router
over E experts of which k serve each token (SwiGLU experts of width
`moe_intermediate_size`, no shared expert).

Its weights are the program's serving form in bfloat16: per layer a fused
`qkv_w` beside `o_w`, the per-head norms `q_norm_w` / `k_norm_w`, the
router `router_w` (d, E), and the experts stacked as `experts_gateup_w`
(E, d, 2F; gate | up) and `experts_down_w` (E, F, d), each stacked over the
layers; the token embedding and an untied output head.
"""

from __future__ import annotations

from typing import Dict


def attention_params(model: Dict) -> int:
    """Weights of one layer's attention products (qkv and o)."""
    d, hd = model["hidden_size"], model["head_dim"]
    qd, kvd = model["num_attention_heads"] * hd, model["num_key_value_heads"] * hd
    return d * (qd + 2 * kvd) + qd * d


def expert_params(model: Dict) -> int:
    """Weights of one expert (gate, up and down)."""
    return 3 * model["hidden_size"] * model["moe_intermediate_size"]


def active_layer_params(model: Dict) -> int:
    """Weights one token multiplies in one layer: attention, the router and
    its k experts."""
    return (attention_params(model) + model["hidden_size"] * model["num_experts"]
            + model["num_experts_per_tok"] * expert_params(model))


def text_spec(model: Dict) -> Dict:
    """The `text` subtree's leaves as (shape, kind)."""
    d, nl, v, hd = model["hidden_size"], model["num_hidden_layers"], model["vocab_size"], model["head_dim"]
    qd, kvd = model["num_attention_heads"] * hd, model["num_key_value_heads"] * hd
    e, fe = model["num_experts"], model["moe_intermediate_size"]
    layers = {
        "input_ln_w": ((nl, d), "one"),
        "post_ln_w": ((nl, d), "one"),
        "qkv_w": ((nl, d, qd + 2 * kvd), "w"),
        "o_w": ((nl, qd, d), "w"),
        "q_norm_w": ((nl, hd), "one"),
        "k_norm_w": ((nl, hd), "one"),
        "router_w": ((nl, d, e), "w"),
        "experts_gateup_w": ((nl, e, d, 2 * fe), "w"),
        "experts_down_w": ((nl, e, fe, d), "w"),
    }
    text = {"embed": ((v, d), "w"), "layers": layers, "final_ln_w": ((d,), "one")}
    if not model["tie_word_embeddings"]:
        text["lm_head"] = ((v, d), "w")
    return text


def text_flops(model: Dict, prompt_tokens: int, generated: int) -> float:
    """The text layers' operations for one query: the prefill over its real
    prompt tokens (causal) and a decode forward for every generated token
    after the first; each token multiplies the active weights (attention,
    router, k experts) and attends over the tokens before it."""
    qd = model["num_attention_heads"] * model["head_dim"]
    nl = model["num_hidden_layers"]
    layer = active_layer_params(model)
    p = prompt_tokens
    prefill = 2.0 * layer * nl * p + 4.0 * qd * nl * p * (p + 1) / 2
    steps = max(generated - 1, 0)
    ctx = steps * p + steps * (steps + 1) / 2  # keys each decode token attends over, summed
    decode = 2.0 * layer * nl * steps + 4.0 * qd * nl * ctx
    return prefill + decode


def expert_work(model: Dict, rows: float, experts_hit: float):
    """(operations, bytes) of H11's two products over `rows` token-expert
    choices that hit `experts_hit` (layer, expert) pairs: each row
    multiplies one expert's three matrices; each expert hit is read once
    in bf16, and each row's bf16 activations go in and out of both
    products (d in and F out, F in and d out)."""
    d, fe = model["hidden_size"], model["moe_intermediate_size"]
    ops = 2.0 * rows * expert_params(model)
    nbytes = 2.0 * experts_hit * expert_params(model) + 2.0 * rows * 2 * (d + fe)
    return ops, nbytes
