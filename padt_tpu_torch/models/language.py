"""Qwen2.5 text decoder with M-RoPE and a static-shape KV cache (port of
`padt_tpu/models/language.py`, unpacked weights, bf16 KV).

`prefill` runs the causal forward over the prompt and seeds the cache;
`decode_step` runs one token over it. Both return post-final-norm hidden
states. q/k rope runs through the H1 kernel and prefill attention through
H2 on the card; decode attention is plain PyTorch, as JAX leaves it to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from padt_tpu.config import TextConfig

from ..ops.attention import causal_attention, decode_attention
from ..ops.cuda_attention import rope_qk
from ..ops.norms import rms_norm
from ..ops.rope import mrope_cos_sin
from .params import normal, ones, zeros


@dataclass
class KVCache:
    k: torch.Tensor  # (layers, B, C, Hkv, hd)
    v: torch.Tensor  # (layers, B, C, Hkv, hd)
    valid: torch.Tensor  # (B, C) bool: live slots (left padding stays False)
    length: int  # slots written so far (the same for every row)


def init_cache(cfg: TextConfig, batch: int, capacity: int, dtype, device) -> KVCache:
    shape = (cfg.num_hidden_layers, batch, capacity, cfg.num_key_value_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        valid=torch.zeros((batch, capacity), dtype=torch.bool, device=device),
        length=0,
    )


def init_text_params(cfg: TextConfig, generator: torch.Generator, device, dtype):
    """Random init with the JAX tree's keys, shapes and dtypes."""
    d, ff, nl = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    qd = cfg.num_attention_heads * cfg.head_dim
    kvd = cfg.num_key_value_heads * cfg.head_dim
    g = lambda *shape: normal(generator, shape, device, dtype)
    layers = {
        "input_ln_w": ones((nl, d), device, dtype),
        "post_ln_w": ones((nl, d), device, dtype),
        "q_w": g(nl, d, qd),
        "q_b": zeros((nl, qd), device, dtype),
        "k_w": g(nl, d, kvd),
        "k_b": zeros((nl, kvd), device, dtype),
        "v_w": g(nl, d, kvd),
        "v_b": zeros((nl, kvd), device, dtype),
        "o_w": g(nl, qd, d),
        "gate_w": g(nl, d, ff),
        "up_w": g(nl, d, ff),
        "down_w": g(nl, ff, d),
    }
    params = {"embed": g(cfg.vocab_size, d), "layers": layers, "final_ln_w": ones((d,), device, dtype)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = g(cfg.vocab_size, d)
    return params


def _layer(params, li: int):
    return {k: v[li] for k, v in params["layers"].items()}


def _qkv_rot(xn, lp, cfg: TextConfig, cos, sin):
    """Projections + rope -> q (B, L, H, hd), k and v (B, L, Hkv, hd)."""
    b, l, _ = xn.shape
    h, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    qp = xn @ lp["q_w"] + lp["q_b"]
    kp = xn @ lp["k_w"] + lp["k_b"]
    v = (xn @ lp["v_w"] + lp["v_b"]).reshape(b, l, hkv, hd)
    q, k = rope_qk(qp, kp, cos, sin, h, hkv)
    return q.reshape(b, l, h, hd), k.reshape(b, l, hkv, hd), v


def _mlp(x, lp):
    return (F.silu(x @ lp["gate_w"]) * (x @ lp["up_w"])) @ lp["down_w"]


def prefill(
    params,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # (B, L, D)
    position_ids: torch.Tensor,  # (3, B, L)
    valid: torch.Tensor,  # (B, L) bool
    capacity: int,
    kv_dtype: str = "bf16",
    batch_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Causal forward; the cache holds the prompt's K/V in slots [0, L).

    kv_dtype "bf16" keeps K/V in the activations' dtype (the JAX name);
    "int8" is the next slice of the port (its decode kernel is not ported
    yet). batch_chunk: run each layer over row chunks of this size (when it
    divides B and B > chunk); rows are independent, so the result is the
    same and only per-layer transients shrink."""
    if kv_dtype == "int8":
        raise NotImplementedError(
            "int8 KV cache is the next slice of the port (int8 decode kernel, "
            "padt_tpu/ops/kv_cache.py::_decode_kernel_stacked_fresh_bb)"
        )
    if kv_dtype != "bf16":
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    b, l, _ = inputs_embeds.shape
    cos, sin = mrope_cos_sin(position_ids, cfg.head_dim, cfg.mrope_section, cfg.rope_theta)
    cache = init_cache(cfg, b, capacity, inputs_embeds.dtype, inputs_embeds.device)
    chunked = bool(batch_chunk) and b > batch_chunk and b % batch_chunk == 0
    bounds = [(i, i + batch_chunk) for i in range(0, b, batch_chunk)] if chunked else [(0, b)]
    x = inputs_embeds
    for li in range(cfg.num_hidden_layers):
        lp = _layer(params, li)
        outs = []
        for s0, s1 in bounds:
            xc = x[s0:s1]
            xn = rms_norm(xc, lp["input_ln_w"], cfg.rms_norm_eps)
            q, k, v = _qkv_rot(xn, lp, cfg, cos[s0:s1], sin[s0:s1])
            attn = causal_attention(q, k, v, valid[s0:s1])
            xc = xc + attn.reshape(s1 - s0, l, -1) @ lp["o_w"]
            xc = xc + _mlp(rms_norm(xc, lp["post_ln_w"], cfg.rms_norm_eps), lp)
            cache.k[li, s0:s1, :l] = k
            cache.v[li, s0:s1, :l] = v
            outs.append(xc)
        x = torch.cat(outs) if chunked else outs[0]
    hidden = rms_norm(x, params["final_ln_w"], cfg.rms_norm_eps)
    cache.valid[:, :l] = valid
    cache.length = l
    return hidden, cache


def decode_step(
    params,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # (B, 1, D)
    position_ids: torch.Tensor,  # (3, B, 1)
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step at slot `cache.length`.

    Updates `cache` IN PLACE (each layer's new K/V row via `index_copy_`,
    the slot's `valid` bit, `length`) and returns it, unlike the JAX
    version, which returns a new cache."""
    if cache.length >= cache.k.shape[2]:
        raise ValueError(f"KV cache full ({cache.length} slots)")
    b = inputs_embeds.shape[0]
    cos, sin = mrope_cos_sin(position_ids, cfg.head_dim, cfg.mrope_section, cfg.rope_theta)
    pos = cache.length
    slot = torch.tensor([pos], device=inputs_embeds.device)
    cache.valid[:, pos] = True
    x = inputs_embeds
    for li in range(cfg.num_hidden_layers):
        lp = _layer(params, li)
        xn = rms_norm(x, lp["input_ln_w"], cfg.rms_norm_eps)
        q, k, v = _qkv_rot(xn, lp, cfg, cos, sin)
        cache.k[li].index_copy_(1, slot, k)
        cache.v[li].index_copy_(1, slot, v)
        attn = decode_attention(q, cache.k[li], cache.v[li], cache.valid)
        x = x + attn.reshape(b, 1, -1) @ lp["o_w"]
        x = x + _mlp(rms_norm(x, lp["post_ln_w"], cfg.rms_norm_eps), lp)
    cache.length = pos + 1
    return rms_norm(x, params["final_ln_w"], cfg.rms_norm_eps), cache
