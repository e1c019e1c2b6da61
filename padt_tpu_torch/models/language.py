"""Qwen2.5 text decoder with M-RoPE and a static-shape KV cache (port of
`padt_tpu/models/language.py`): unpacked or packed (`pack_inference_params`)
weights in bf16 or int8 (`quantize_params`), a bf16 or an int8 KV cache.

`prefill` runs the causal forward over the prompt and seeds the cache;
`decode_step` runs one token over it; `text_forward` is the training
forward (optionally checkpointed per layer). All return post-final-norm
hidden states. q/k rope runs through the H1 kernel and prefill attention
through H2 on the card; under autograd through their Functions
(`ops.attention.rope_pair_packed`, `flash_attention`), whose backwards are
H1 with the sin negated and H8/H9. bf16 decode attention is plain PyTorch,
as JAX leaves it to XLA; int8 decode attention is H4 and its row store H6. Every product with
an int8 weight (`*_w_q` / `*_w_s`) goes through H7 (`ops.quant.linear`).

A config with experts (`TextConfig.num_experts`, Qwen3-MoE's block, which
the JAX package does not have) replaces the dense MLP by `ops.moe.moe_mlp`
(router in float32, top-k, H11's two grouped products); `attention_bias`
False drops the q/k/v biases and `qk_norm` adds an RMSNorm over each q and
k head before rope.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import TextConfig, text_opt
from ..ops.attention import causal_attention, decode_attention, rope_pair_packed
from ..ops.kv_cache import decode_attention_int8, empty_scale, quantize_kv, store_kv_rows_all_layers
from ..ops.moe import Tally, moe_mlp
from ..ops.norms import rms_norm
from ..ops.quant import linear as qlinear
from ..ops.rope import mrope_cos_sin
from .params import normal, ones, zeros


@dataclass
class KVCache:
    k: torch.Tensor  # (layers, B, C, Hkv, hd)
    v: torch.Tensor  # (layers, B, C, Hkv, hd)
    valid: torch.Tensor  # (B, C) bool: live slots (left padding stays False)
    length: int  # slots written so far (the same for every row)


@dataclass
class QuantKVCache:
    """Int8 KV cache: per-token, per-kv-head symmetric quantization; C next
    to hd so each (sample, head) slice is one contiguous (C, hd) tile."""

    k: torch.Tensor  # (layers, B, Hkv, C, hd) int8
    k_scale: torch.Tensor  # (layers, B, Hkv, C) fp32
    v: torch.Tensor
    v_scale: torch.Tensor
    valid: torch.Tensor  # (B, C) bool
    length: int


def init_cache(cfg: TextConfig, batch: int, capacity: int, dtype, device) -> KVCache:
    shape = (cfg.num_hidden_layers, batch, capacity, cfg.num_key_value_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        valid=torch.zeros((batch, capacity), dtype=torch.bool, device=device),
        length=0,
    )


def init_quant_cache(cfg: TextConfig, batch: int, capacity: int, device) -> QuantKVCache:
    """Every row as `quantize_kv` leaves an all-zero (padding) row: value 0,
    scale 1e-8 / 127."""
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, capacity)
    return QuantKVCache(
        k=torch.zeros((*shape, cfg.head_dim), dtype=torch.int8, device=device),
        k_scale=torch.full(shape, empty_scale(), dtype=torch.float32, device=device),
        v=torch.zeros((*shape, cfg.head_dim), dtype=torch.int8, device=device),
        v_scale=torch.full(shape, empty_scale(), dtype=torch.float32, device=device),
        valid=torch.zeros((batch, capacity), dtype=torch.bool, device=device),
        length=0,
    )


def quantize_cache(cache: KVCache) -> QuantKVCache:
    """bf16 cache (e.g. fresh from prefill) -> int8 cache."""
    k8, ks = quantize_kv(cache.k.permute(0, 1, 3, 2, 4))
    v8, vs = quantize_kv(cache.v.permute(0, 1, 3, 2, 4))
    return QuantKVCache(k=k8, k_scale=ks, v=v8, v_scale=vs, valid=cache.valid, length=cache.length)


def init_text_params(cfg: TextConfig, generator: torch.Generator, device, dtype):
    """Random init with the JAX tree's keys, shapes and dtypes; a config
    without attention bias has no `*_b` leaves, one with `qk_norm` has the
    per-head norms `q_norm_w` / `k_norm_w` (L, hd), and one with experts
    has `router_w` (L, d, E), `experts_gateup_w` (L, E, d, 2F, gate | up)
    and `experts_down_w` (L, E, F, d) in place of the dense MLP's leaves."""
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
    }
    if not cfg.attention_bias:
        for name in ("q_b", "k_b", "v_b"):
            del layers[name]
    if text_opt(cfg, "qk_norm"):
        layers["q_norm_w"] = ones((nl, cfg.head_dim), device, dtype)
        layers["k_norm_w"] = ones((nl, cfg.head_dim), device, dtype)
    if text_opt(cfg, "num_experts"):
        e, fe = cfg.num_experts, cfg.moe_intermediate_size
        layers.update(router_w=g(nl, d, e), experts_gateup_w=g(nl, e, d, 2 * fe), experts_down_w=g(nl, e, fe, d))
    else:
        layers.update(gate_w=g(nl, d, ff), up_w=g(nl, d, ff), down_w=g(nl, ff, d))
    params = {"embed": g(cfg.vocab_size, d), "layers": layers, "final_ln_w": ones((d,), device, dtype)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = g(cfg.vocab_size, d)
    return params


def _layer(params, li: int):
    return {k: v[li] for k, v in params["layers"].items()}


def _packed(lp) -> bool:
    """True for the fused serving layout (`qkv_w` or `qkv_w_q`)."""
    return "qkv_w" in lp or "qkv_w_q" in lp


def _qkv_rot(xn, lp, cfg: TextConfig, cos, sin):
    """Projections (+ bias where the config has it; with `qk_norm` an
    RMSNorm over each q and k head) + rope -> q (B, L, H, hd), k and v (B,
    L, Hkv, hd). With packed weights (`qkv_w`, one fused product), H1 reads
    q and k as column views of the fused output and v stays a view of it."""
    b, l, _ = xn.shape
    h, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    qk_norm, eps = text_opt(cfg, "qk_norm"), cfg.rms_norm_eps
    if _packed(lp):
        qkv = qlinear(lp, "qkv_w", xn)
        if cfg.attention_bias:
            qkv = qkv + lp["qkv_b"]
        qk = qkv[..., : (h + hkv) * hd]
        v = qkv[..., (h + hkv) * hd :].unflatten(-1, (hkv, hd))
        if qk_norm:  # one norm over the q and k heads side by side
            w = torch.cat((lp["q_norm_w"].expand(h, hd), lp["k_norm_w"].expand(hkv, hd)))
            qk = rms_norm(qk.unflatten(-1, (h + hkv, hd)), w, eps).flatten(-2)
        qp, kp = qk[..., : h * hd], qk[..., h * hd :]
    else:
        qp, kp, vp = (qlinear(lp, n + "_w", xn) for n in ("q", "k", "v"))
        if cfg.attention_bias:
            qp, kp, vp = qp + lp["q_b"], kp + lp["k_b"], vp + lp["v_b"]
        v = vp.reshape(b, l, hkv, hd)
        if qk_norm:
            qp = rms_norm(qp.unflatten(-1, (h, hd)), lp["q_norm_w"], eps).flatten(-2)
            kp = rms_norm(kp.unflatten(-1, (hkv, hd)), lp["k_norm_w"], eps).flatten(-2)
    q, k = rope_pair_packed(qp, kp, cos, sin, h, hkv)
    return q.reshape(b, l, h, hd), k.reshape(b, l, hkv, hd), v


def _mlp(x, lp, cfg: Optional[TextConfig] = None, real=None, counts=None, rec=None):
    """The dense SwiGLU MLP, or with experts `ops.moe.moe_mlp` (the choices
    of the tokens `real` marks go to the layer's `counts` where given; its
    host spans to `rec`)."""
    if cfg is not None and text_opt(cfg, "num_experts"):
        return moe_mlp(x, lp["router_w"], lp["experts_gateup_w"], lp["experts_down_w"], cfg.num_experts_per_tok,
                       cfg.norm_topk_prob, real=real, counts=counts, rec=rec)
    if "gateup_w" in lp or "gateup_w_q" in lp:
        gu = qlinear(lp, "gateup_w", x)
        ff = gu.shape[-1] // 2
        return qlinear(lp, "down_w", F.silu(gu[..., :ff]) * gu[..., ff:])
    return qlinear(lp, "down_w", F.silu(qlinear(lp, "gate_w", x)) * qlinear(lp, "up_w", x))


def _unbound_layers(params):
    """The stacked (layers, ...) leaves as one dict per layer. Each leaf is
    unbound once, so under autograd its gradient is one stack of the
    per-layer gradients (indexing v[li] instead would build a zero tensor of
    the whole stack per layer in the backward)."""
    names = list(params["layers"])
    return [dict(zip(names, vals)) for vals in zip(*(torch.unbind(params["layers"][n]) for n in names))]


def text_forward(
    params,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # (B, L, D)
    position_ids: torch.Tensor,  # (3, B, L)
    valid: torch.Tensor,  # (B, L) bool
    remat: bool = False,
):
    """Full causal forward. Returns (hidden post-final-norm (B, L, D),
    (k_all, v_all) each (layers, B, L, Hkv, hd)). remat: each layer body
    runs under `torch.utils.checkpoint` (non-reentrant), so the backward
    recomputes it from the layer's input instead of keeping its
    activations."""
    b, l, _ = inputs_embeds.shape
    cos, sin = mrope_cos_sin(position_ids, cfg.head_dim, cfg.mrope_section, cfg.rope_theta)
    eps = cfg.rms_norm_eps

    def body(x, lp):
        q, k, v = _qkv_rot(rms_norm(x, lp["input_ln_w"], eps), lp, cfg, cos, sin)
        x = x + qlinear(lp, "o_w", causal_attention(q, k, v, valid).reshape(b, l, -1))
        return x + _mlp(rms_norm(x, lp["post_ln_w"], eps), lp, cfg), k, v

    x, ks, vs = inputs_embeds, [], []
    for lp in _unbound_layers(params):
        x, k, v = checkpoint(body, x, lp, use_reentrant=False) if remat else body(x, lp)
        ks.append(k)
        vs.append(v)
    return rms_norm(x, params["final_ln_w"], eps), (torch.stack(ks), torch.stack(vs))


def prefill(
    params,
    cfg: TextConfig,
    inputs_embeds: torch.Tensor,  # (B, L, D)
    position_ids: torch.Tensor,  # (3, B, L)
    valid: torch.Tensor,  # (B, L) bool
    capacity: int,
    kv_dtype: str = "bf16",
    batch_chunk: Optional[int] = None,
    real: Optional[torch.Tensor] = None,
    tally: Optional[Tally] = None,
    rec=None,
):
    """Causal forward; the cache holds the prompt's K/V in slots [0, L).

    kv_dtype "bf16" keeps K/V in the activations' dtype (the JAX name) and
    returns a `KVCache`; "int8" quantizes each layer's K/V inside the layer
    loop (no bf16 stack of all layers is ever held) and returns a
    `QuantKVCache` whose rows past L hold what quantizing zero padding gives.
    batch_chunk: run each layer over row chunks of this size (when it divides
    B and B > chunk); rows are independent, so the result is the same and
    only per-layer transients shrink. With experts, `tally` (`ops.moe.Tally`)
    gains the choices of the tokens `real` (B, L) marks and the (layer,
    expert) pairs they hit, and `rec` the `moe.*` host spans."""
    if kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    b, l, _ = inputs_embeds.shape
    cos, sin = mrope_cos_sin(position_ids, cfg.head_dim, cfg.mrope_section, cfg.rope_theta)
    dev = inputs_embeds.device
    int8 = kv_dtype == "int8"
    cache = init_quant_cache(cfg, b, capacity, dev) if int8 else init_cache(cfg, b, capacity, inputs_embeds.dtype, dev)
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
            xc = xc + qlinear(lp, "o_w", attn.reshape(s1 - s0, l, -1))
            rc, counts = (None, None) if tally is None else (real[s0:s1], tally.counts[li])
            xc = xc + _mlp(rms_norm(xc, lp["post_ln_w"], cfg.rms_norm_eps), lp, cfg, rc, counts, rec)
            if int8:
                cache.k[li, s0:s1, :, :l], cache.k_scale[li, s0:s1, :, :l] = quantize_kv(k.transpose(1, 2))
                cache.v[li, s0:s1, :, :l], cache.v_scale[li, s0:s1, :, :l] = quantize_kv(v.transpose(1, 2))
            else:
                cache.k[li, s0:s1, :l] = k
                cache.v[li, s0:s1, :l] = v
            outs.append(xc)
        x = torch.cat(outs) if chunked else outs[0]
    if tally is not None:
        tally.fold()
    hidden = rms_norm(x, params["final_ln_w"], cfg.rms_norm_eps)
    cache.valid[:, :l] = valid
    cache.length = l
    return hidden, cache


def decode_step(params, cfg: TextConfig, inputs_embeds: torch.Tensor, position_ids: torch.Tensor, cache):
    """One decode step at slot `cache.length` (inputs_embeds (B, 1, D),
    position_ids (3, B, 1)).

    Updates `cache` IN PLACE (the new K/V row of every layer, the slot's
    `valid` bit, `length`) and returns it, unlike the JAX version, which
    returns a new cache."""
    if cache.length >= cache.valid.shape[1]:
        raise ValueError(f"KV cache full ({cache.length} slots)")
    if isinstance(cache, QuantKVCache):
        return _decode_step_int8(params, cfg, inputs_embeds, position_ids, cache)
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
        x = x + qlinear(lp, "o_w", attn.reshape(b, 1, -1))
        x = x + _mlp(rms_norm(x, lp["post_ln_w"], cfg.rms_norm_eps), lp, cfg)
    cache.length = pos + 1
    return rms_norm(x, params["final_ln_w"], cfg.rms_norm_eps), cache


def int8_layers(params, cfg: TextConfig, x, cos, sin, attend, real=None, tally=None, rec=None):
    """The text layers over an int8 cache that stays unchanged inside the
    loop (x (B, n, D): n new tokens). Each layer's new K/V rows are
    quantized and handed to `attend(q, layer, fresh)` as its fresh columns
    (H4 or H5 on the card). Returns the post-final-norm hidden and the new
    rows of every layer for one store after the loop, stacked:
    (k8r (L, B, Hkv, n, hd), ksr (L, B, Hkv, n), v8r, vsr). Each layer
    quantizes straight into its slice of these buffers, so no copy stacks
    them. `real`, `tally` and `rec` as in `prefill`."""
    b, n, _ = x.shape
    nl, hkv, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    i8 = lambda: torch.empty((nl, b, hkv, n, hd), dtype=torch.int8, device=x.device)
    f32 = lambda: torch.empty((nl, b, hkv, n), dtype=torch.float32, device=x.device)
    stacked = (i8(), f32(), i8(), f32())
    k8r, ksr, v8r, vsr = (t.unbind(0) for t in stacked)
    for li in range(nl):
        lp = _layer(params, li)
        q, k, v = _qkv_rot(rms_norm(x, lp["input_ln_w"], cfg.rms_norm_eps), lp, cfg, cos, sin)
        fresh = (*quantize_kv(k.transpose(1, 2), out=(k8r[li], ksr[li])),
                 *quantize_kv(v.transpose(1, 2), out=(v8r[li], vsr[li])))
        x = x + qlinear(lp, "o_w", attend(q, li, fresh).reshape(b, n, -1))
        counts = None if tally is None else tally.counts[li]
        x = x + _mlp(rms_norm(x, lp["post_ln_w"], cfg.rms_norm_eps), lp, cfg, real, counts, rec)
    if tally is not None:
        tally.fold()
    return rms_norm(x, params["final_ln_w"], cfg.rms_norm_eps), stacked


def _decode_step_int8(params, cfg: TextConfig, inputs_embeds, position_ids, cache: QuantKVCache):
    """One int8-KV decode step: H4 reads each layer of the pre-update cache
    with the current token as its fresh column; one H6 launch then writes
    every layer's new row at `cache.length`."""
    cos, sin = mrope_cos_sin(position_ids, cfg.head_dim, cfg.mrope_section, cfg.rope_theta)
    pos = cache.length
    hidden, new_rows = int8_layers(
        params, cfg, inputs_embeds, cos, sin,
        lambda q, li, fresh: decode_attention_int8(
            q, cache.k, cache.k_scale, cache.v, cache.v_scale, cache.valid, layer=li, fresh_kv=fresh,
        ),
    )
    at = torch.full((inputs_embeds.shape[0],), pos, dtype=torch.int32, device=inputs_embeds.device)
    store_kv_rows_all_layers(cache.k, cache.k_scale, cache.v, cache.v_scale, *new_rows, at)
    cache.valid[:, pos] = True
    cache.length = pos + 1
    return hidden, cache
