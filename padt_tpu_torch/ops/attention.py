"""Attention ops (port of `padt_tpu/ops/attention.py`).

The vision and prefill attention go through the Hopper kernels of
`cuda_attention` (their wrappers take the plain twins for CPU tensors):
  - `segment_attention`, `causal_attention`, `fused_vision_attention_qkv` ->
    H2 `segment_flash_fwd` (after H1 `rope_qk` for the fused vision qkv);
  - `window_attention_qkv` -> H1 `rope_qk` + H3 `window_slot_attn`.
`decode_attention` and `masked_cross_attention` are plain PyTorch, as the
JAX package leaves them to XLA.

Training: `flash_attention` is the autograd Function of JAX's
`flash_attention` custom VJP (`pallas_attention.py:227-265,453-538`): H2
with its LSE output forward, H8/H9 backward. `rope_pair_packed` is that of
`rope_pair_packed` (`:649-679`): H1 forward, H1 with the sin negated
backward. The two vision calls port JAX's `vision_flash_attention_qkv`
(`:1051-1105`) and `vision_window_attention_qkv` (`:941-981`), whose
backward is one `_vis_qkv_bwd`: under grad both run H1 on the q/k views of
the fused qkv and H2 with its LSE, non-causally over their segment ids
(the windowed layers' slot ids express the window mask, so H3, which has
no backward, stays their inference forward), and their backward is H8 +
H9, then H1 with the sin negated, with d(qkv) written once. Every call
takes its Function only when grad mode is on and an input requires grad,
so inference launches exactly what it did before.

Rows with no valid key: the kernels and their twins return 0, as the TPU
kernels do. The JAX XLA branches return a finite uniform average there
(NEG_INF fill); downstream masks drop those rows either way.
"""

from __future__ import annotations

from typing import Optional

import torch

from .cuda_attention import WINDOW, rope_qk, segment_flash_fwd, window_slot_attn
from .cuda_flash_bwd import flash_bwd_dkv, flash_bwd_dq

NEG_INF = -1e30


def _scale(d: int, scale: Optional[float], rope_dim: Optional[int]) -> float:
    if rope_dim not in (None, d):
        raise ValueError(f"rope_dim {rope_dim} != head dim {d}: partial rotary is not supported")
    return (1.0 / (d**0.5)) if scale is None else scale


def segment_attention(q, k, v, seg, scale: Optional[float] = None):
    """Block-diagonal attention over segment ids (-1 = pad); (B, S, H, D)."""
    return segment_flash_fwd(q, k, v, seg, seg, False, _scale(q.shape[-1], scale, None))


def _rope_split_qkv(qkv, cos, sin, num_heads: int):
    """Fused (B, S, 3*H*D) qkv -> rotated q, k and the v view (each (B, S, H, D));
    the rope kernel reads q/k straight out of qkv, v is never copied."""
    b, s, dh3 = qkv.shape
    d = dh3 // (3 * num_heads)
    hd = num_heads * d
    q_rot, k_rot = rope_qk(qkv[..., :hd], qkv[..., hd : 2 * hd], cos, sin, num_heads, num_heads)
    split = lambda t: t.unflatten(-1, (num_heads, d))
    return split(q_rot), split(k_rot), split(qkv[..., 2 * hd :])


def fused_vision_attention_qkv(
    qkv, cos, sin, seg, num_heads: int,
    scale: Optional[float] = None, rope_dim: Optional[int] = None,
):
    """Full (segment) vision attention on the fused pre-rope qkv -> (B, S, H*D);
    differentiable (`_VisionFlashQKV`) when qkv requires grad."""
    b, s, _ = qkv.shape
    if _needs_grad(qkv):
        return _VisionFlashQKV.apply(qkv, cos, sin, seg, num_heads, _scale(cos.shape[-1], scale, rope_dim))
    q, k, v = _rope_split_qkv(qkv, cos, sin, num_heads)
    out = segment_flash_fwd(q, k, v, seg, seg, False, _scale(q.shape[-1], scale, rope_dim))
    return out.reshape(b, s, -1)


def window_attention_qkv(
    qkv, cos, sin, seg, num_heads: int, win: int = WINDOW,
    scale: Optional[float] = None, rope_dim: Optional[int] = None,
):
    """Windowed vision attention on the 64-token slot layout -> (B, S, H*D).
    Under grad (qkv requires grad) it is segment attention over the slot ids
    `seg`, the same mask on every valid row, through `_VisionFlashQKV`: a
    pad row then gives 0 where H3 gives the window's average, and no valid
    row reads a pad row."""
    if win != WINDOW:
        raise ValueError(f"window slots are {WINDOW} tokens, got {win}")
    b, s, _ = qkv.shape
    if _needs_grad(qkv):
        return _VisionFlashQKV.apply(qkv, cos, sin, seg, num_heads, _scale(cos.shape[-1], scale, rope_dim))
    q, k, v = _rope_split_qkv(qkv, cos, sin, num_heads)
    out = window_slot_attn(q, k, v, seg, _scale(q.shape[-1], scale, rope_dim))
    return out.reshape(b, s, -1)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


class _FlashAttention(torch.autograd.Function):
    """Segment flash attention with the flash backward: the forward saves q,
    k, v, the segment ids, the output and the LSE; the backward forms delta =
    rowsum(dO * O) in fp32 (plain PyTorch, as JAX leaves it to XLA) and runs
    H8 (dq) and H9 (dk, dv)."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, k_seg, causal: bool, scale: float):
        out, lse = segment_flash_fwd(q, k, v, q_seg, k_seg, causal, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, q_seg, k_seg, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_seg, k_seg, out, lse = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()  # (B, H, Sq)
        args = (q, k, v, g, q_seg, k_seg, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_bwd_dkv(*args)
        return flash_bwd_dq(*args), dk, dv, None, None, None, None


def flash_attention(q, k, v, q_seg, k_seg, causal: bool = False, scale: Optional[float] = None):
    """Differentiable segment attention; q (B, Sq, H, D), k/v (B, Sk, Hkv,
    D), segment ids (B, S) int32 (-1 = pad). Rows with no visible key give 0."""
    scale = (1.0 / (q.shape[-1] ** 0.5)) if scale is None else scale
    return _FlashAttention.apply(q, k, v, q_seg, k_seg, causal, scale)


class _VisionFlashQKV(torch.autograd.Function):
    """JAX's `vision_flash_attention_qkv` custom VJP on the fused pre-rope
    qkv (B, S, 3*H*hd): the forward runs H1 on its q/k views and H2 with its
    LSE, non-causally over `seg`, and saves the rotated q/k, the output and
    the LSE; the backward (`_vis_qkv_bwd`) runs H8 and H9 on them, H1 with
    the sin negated on dq/dk in one launch, and writes d(qkv) once by
    concatenation, as JAX's `concatenate` does."""

    @staticmethod
    def forward(ctx, qkv, cos, sin, seg, num_heads: int, scale: float):
        b, s, _ = qkv.shape
        q, k, v = _rope_split_qkv(qkv, cos, sin, num_heads)
        out, lse = segment_flash_fwd(q, k, v, seg, seg, False, scale, return_lse=True)
        out = out.reshape(b, s, -1)
        ctx.save_for_backward(qkv, q, k, cos, sin, seg, out, lse)
        ctx.heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, q, k, cos, sin, seg, out, lse = ctx.saved_tensors
        b, s, h, hd = q.shape
        v = qkv[..., 2 * h * hd :].unflatten(-1, (h, hd))
        g = g.to(q.dtype).reshape(b, s, h, hd).contiguous()
        delta = (g.float() * out.float().unflatten(-1, (h, hd))).sum(-1).transpose(1, 2).contiguous()  # (B, H, S)
        args = (q, k, v, g, seg, seg, lse, delta, False, ctx.scale)
        dk, dv = flash_bwd_dkv(*args)
        dq, dk = rope_qk(flash_bwd_dq(*args).flatten(2), dk.flatten(2), cos, sin, h, h, sin_sign=-1.0)
        return torch.cat([dq, dk, dv.flatten(2)], dim=-1), None, None, None, None, None


def causal_attention(q, k, v, valid):
    """Causal GQA self-attention for the text prefill; `valid` (B, L) bool
    marks the non-pad (left-padded) positions. Differentiable through
    `flash_attention` when an input requires grad."""
    seg = torch.where(valid, 0, -1).to(torch.int32)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    if _needs_grad(q, k, v):
        return flash_attention(q, k, v, seg, seg, True, scale)
    return segment_flash_fwd(q, k, v, seg, seg, True, scale)


class _RopePairPacked(torch.autograd.Function):
    """H1 rope on q and (optionally) k; the backward is H1 on the cotangents
    with the sin negated (the rotation's transpose, since the tables' halves
    repeat); cos/sin get no gradient (positions are integers)."""

    @staticmethod
    def forward(ctx, q, k, cos, sin, num_q_heads: int, num_k_heads: int):
        ctx.save_for_backward(cos, sin)
        ctx.heads = (num_q_heads, num_k_heads)
        qr, kr = rope_qk(q, k, cos, sin, num_q_heads, num_k_heads)
        return qr if kr is None else (qr, kr)

    @staticmethod
    def backward(ctx, gq, gk=None):
        cos, sin = ctx.saved_tensors
        hq, hk = ctx.heads
        dq, dk = rope_qk(gq.contiguous(), None if hk == 0 else gk.contiguous(), cos, sin, hq, hk, sin_sign=-1.0)
        return dq, dk, None, None, None, None


def rope_pair_packed(q, k, cos, sin, num_q_heads: int, num_k_heads: int):
    """`rope_qk` (q (B, S, Hq*hd), k (B, S, Hk*hd) or None; fp32 cos/sin
    (B, S, hd)) -> (q_rot, k_rot or None), differentiable through H1's VJP
    when an input requires grad."""
    if not _needs_grad(q, k):
        return rope_qk(q, k, cos, sin, num_q_heads, num_k_heads)
    if k is None:
        return _RopePairPacked.apply(q, None, cos, sin, num_q_heads, 0), None
    return _RopePairPacked.apply(q, k, cos, sin, num_q_heads, num_k_heads)


def decode_attention(q, k_cache, v_cache, valid):
    """One query step over the cache. q (B, 1, H, D), caches (B, C, Hkv, D),
    valid (B, C) bool. Grouped-query form, no repeated kv."""
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).float()
    scores = torch.einsum("bkgd,bckd->bkgc", qg, k_cache.float()) * (1.0 / (d**0.5))
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, d)


def masked_cross_attention(q, k, v, q_valid, k_valid):
    """Dense cross-attention with per-side validity masks (the perception
    decoder); q (B, Lq, H, D), k/v (B, Lk, H, D)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    mask = q_valid[:, None, :, None] & k_valid[:, None, None, :]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
