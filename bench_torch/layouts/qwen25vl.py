"""Qwen2.5-VL's text stack (the layout a configuration without a `layout`
key gets): GQA attention with a bias on q, k and v, and a dense SwiGLU MLP
in every layer.

Its weights are the program's serving form: per layer a fused `qkv_w` and
`gateup_w` beside `o_w` and `down_w`, stacked over the layers, in bfloat16
(`text_layer_weights` "bf16") or as int8 values with float32 scales per
output column ("int8"); the token embedding, and an output head where the
embedding is not tied.
"""

from __future__ import annotations

from typing import Dict

from ..lib import counts


def text_spec(model: Dict) -> Dict:
    """The `text` subtree's leaves as (shape, kind)."""
    d, nl, v = model["hidden_size"], model["num_hidden_layers"], model["vocab_size"]
    products = counts.text_layer_weights(model)
    int8 = model["text_layer_weights"] == "int8"
    layers = {"input_ln_w": ((nl, d), "one"), "post_ln_w": ((nl, d), "one"), "qkv_b": ((nl, products["qkv"][1]), "b")}
    for name, (din, dout) in products.items():
        if int8:
            layers[name + "_w_q"] = ((nl, din, dout), "q8")
            layers[name + "_w_s"] = ((nl, 1, dout), "s8")
        else:
            layers[name + "_w"] = ((nl, din, dout), "w")
    text = {"embed": ((v, d), "w"), "layers": layers, "final_ln_w": ((d,), "one")}
    if not model["tie_word_embeddings"]:
        text["lm_head"] = ((v, d), "w")
    return text


def text_flops(model: Dict, prompt_tokens: int, generated: int) -> float:
    """The text layers' operations for one query: the prefill over its real
    prompt tokens (causal), and a decode forward for every generated token
    after the first (each attends over the prompt and the tokens before
    it)."""
    qd = model["num_attention_heads"] * model["head_dim"]
    nl = model["num_hidden_layers"]
    layer = counts.text_layer_params(model)
    p = prompt_tokens
    prefill = 2.0 * layer * nl * p + 4.0 * qd * nl * p * (p + 1) / 2
    steps = max(generated - 1, 0)
    ctx = steps * p + steps * (steps + 1) / 2  # keys each decode token attends over, summed
    decode = 2.0 * layer * nl * steps + 4.0 * qd * nl * ctx
    return prefill + decode
