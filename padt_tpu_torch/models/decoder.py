"""PaDT perception decoder: VRT hidden states -> boxes, scores, masks (port
of `padt_tpu/models/decoder.py`).

Same padded layout as the JAX version: (N objects, 3 + K_max) query grids,
per-object memory gathered from its sample, boolean validity masks, and a
static (N, 4*H_max, 4*W_max) mask canvas. Attention is dense masked
attention in plain PyTorch, as JAX leaves it to XLA; the rotary side of each
cross-attention goes through the rope kernel on the card (under autograd
through `rope_pair_packed`, whose backward is the same kernel).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..config import DecoderConfig
from ..ops.attention import masked_cross_attention, rope_pair_packed
from ..ops.norms import rms_norm
from .params import normal, ones, zeros


def _lin(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def _gelu(x):
    return F.gelu(x, approximate="none")


def _init_lin(g, din, dout, device, dtype, bias=True):
    p = {"w": normal(g, (din, dout), device, dtype)}
    if bias:
        p["b"] = zeros((dout,), device, dtype)
    return p


def _init_attn(g, d, device, dtype):
    return {n: _init_lin(g, d, d, device, dtype) for n in ("q", "k", "v", "o")}


def _init_block(g, cfg: DecoderConfig, device, dtype):
    d, ff = cfg.hidden_size, cfg.intermediate_size
    out = {f"norm{i}_w": ones((d,), device, dtype) for i in range(1, 7)}
    out.update(
        self_attn=_init_attn(g, d, device, dtype),
        cross_q2i=_init_attn(g, d, device, dtype),
        cross_i2q=_init_attn(g, d, device, dtype),
        mlp_fc1=_init_lin(g, d, ff, device, dtype),
        mlp_fc2=_init_lin(g, ff, d, device, dtype),
    )
    return out


def init_decoder_params(cfg: DecoderConfig, generator: torch.Generator, device, dtype):
    """Random init with the JAX tree's keys, shapes and dtypes."""
    d = cfg.hidden_size
    g = generator
    lin = lambda din, dout: _init_lin(g, din, dout, device, dtype)
    return {
        "vp_embedding": normal(g, (d,), device, dtype),
        "bbox_score_mask_tokens": normal(g, (3, d), device, dtype),
        "input_proj": {
            "norm_w": ones((cfg.llm_hidden_size,), device, dtype),
            "fc1": lin(cfg.llm_hidden_size, d),
            "fc2": lin(d, d),
        },
        "low_res": _init_block(g, cfg, device, dtype),
        "high_res1": _init_block(g, cfg, device, dtype),
        "high_res2": _init_block(g, cfg, device, dtype),
        "high_res_norm_w": ones((d,), device, dtype),
        "bbox_fc1": lin(d, d),
        "bbox_fc2": lin(d, d),
        "bbox_fc3": lin(d, 4),
        "score": lin(d, 1),
        "mask_up1": {**lin(d, d // 4 * 4), "norm_w": ones((d // 4 * 4,), device, dtype)},
        "mask_up2": lin(d // 4, d // 16 * 4),
        "mask_mlp_fc1": lin(d, d),
        "mask_mlp_fc2": lin(d, d),
        "mask_mlp_fc3": lin(d, d // 16),
    }


def input_projection(params, cfg: DecoderConfig, x):
    """RMSNorm -> Linear -> GELU -> Linear."""
    p = params["input_proj"]
    return _lin(p["fc2"], _gelu(_lin(p["fc1"], rms_norm(x, p["norm_w"], cfg.rms_norm_eps))))


def _rotary(x, pe, h: int):
    """Rotate the (N, L, H*hd) projection by the per-token (cos, sin)."""
    cos, sin = pe
    out, _ = rope_pair_packed(x, None, cos.float().contiguous(), sin.float().contiguous(), h, 0)
    return out


def _attn(ap, cfg: DecoderConfig, query, key, q_valid, k_valid, q_pos, k_pos, is_rotary):
    n, lq, d = query.shape
    lk = key.shape[1]
    h, hd = cfg.num_heads, cfg.head_dim
    q = _lin(ap["q"], query if is_rotary[0] else query + q_pos)
    k = _lin(ap["k"], key if is_rotary[1] else key + k_pos)
    v = _lin(ap["v"], key).reshape(n, lk, h, hd)
    if is_rotary[0]:
        q = _rotary(q, q_pos, h)
    if is_rotary[1]:
        k = _rotary(k, k_pos, h)
    out = masked_cross_attention(q.reshape(n, lq, h, hd), k.reshape(n, lk, h, hd), v, q_valid, k_valid)
    return _lin(ap["o"], out.reshape(n, lq, d))


def _block(bp, cfg: DecoderConfig, query, memory, q_valid, m_valid, q_pos, m_pe):
    """Two-way block with memory update."""
    eps = cfg.rms_norm_eps
    qn = rms_norm(query, bp["norm1_w"], eps)
    query = query + _attn(bp["self_attn"], cfg, qn, qn, q_valid, q_valid, q_pos, q_pos, (False, False))
    qn = rms_norm(query, bp["norm2_w"], eps)
    mn = rms_norm(memory, bp["norm3_w"], eps)
    query = query + _attn(bp["cross_q2i"], cfg, qn, mn, q_valid, m_valid, q_pos, m_pe, (False, True))
    qn = rms_norm(query, bp["norm4_w"], eps)
    query = query + _lin(bp["mlp_fc2"], _gelu(_lin(bp["mlp_fc1"], qn)))
    qn = rms_norm(query, bp["norm5_w"], eps)
    mn = rms_norm(memory, bp["norm6_w"], eps)
    memory = memory + _attn(bp["cross_i2q"], cfg, mn, qn, m_valid, q_valid, m_pe, q_pos, (True, False))
    return query, memory


class DecoderOutput(NamedTuple):
    pred_boxes: torch.Tensor  # (N, 4) normalized (cx, cy, w, h)
    pred_score: torch.Tensor  # (N, 1) pre-sigmoid
    pred_mask: torch.Tensor  # (N, 4*H_max, 4*W_max) logits
    mask_hw: torch.Tensor  # (N, 2) valid (grid_h, grid_w) per object
    obj_valid: torch.Tensor  # (N,) bool


def decoder_forward(
    params,
    cfg: DecoderConfig,
    vrt_feats,  # (N, K_max, D_llm)
    vrt_counts,  # (N,)
    obj_valid,  # (N,) bool
    obj_sample,  # (N,) sample index per object
    proto,  # (B, M, D_llm) raster order
    high_res,  # (B, S, D_dec) window order
    pe_cos,  # (B, S, head_dim)
    pe_sin,
    num_merged,  # (B,)
    num_patches,  # (B,)
    grid_thw,  # (B, 3)
    canvas_hw: Tuple[int, int],
    compute_mask: bool = True,
) -> DecoderOutput:
    n, k_max, _ = vrt_feats.shape
    b, m, _ = proto.shape
    s = high_res.shape[1]
    d = cfg.hidden_size
    unit = cfg.spatial_merge_size**2
    dtype = high_res.dtype
    dev = high_res.device
    obj_sample = obj_sample.long()

    proj = input_projection(params, cfg, vrt_feats.to(dtype))
    queries = torch.cat(
        [params["bbox_score_mask_tokens"][None].expand(n, 3, d), proj + params["vp_embedding"]], dim=1
    )  # (N, 3 + K, D)
    q_valid = torch.cat(
        [obj_valid[:, None].expand(n, 3), torch.arange(k_max, device=dev)[None, :] < vrt_counts[:, None]],
        dim=1,
    )
    q_pos = queries

    low_mem = input_projection(params, cfg, proto.to(dtype))[obj_sample]  # (N, M, D)
    low_valid = torch.arange(m, device=dev)[None, :] < num_merged[obj_sample][:, None]
    low_cos = pe_cos.reshape(b, m, unit, -1)[:, :, 0][obj_sample]
    low_sin = pe_sin.reshape(b, m, unit, -1)[:, :, 0][obj_sample]

    out, low_mem = _block(params["low_res"], cfg, queries, low_mem, q_valid, low_valid, q_pos, (low_cos, low_sin))

    hi_valid = torch.arange(s, device=dev)[None, :] < num_patches[obj_sample][:, None]
    lifted = low_mem.repeat_interleave(unit, dim=1)  # each merged token over its 4 patches
    hi_mem = rms_norm(lifted + high_res[obj_sample], params["high_res_norm_w"], cfg.rms_norm_eps)
    hi_pe = (pe_cos[obj_sample], pe_sin[obj_sample])
    out, hi_mem = _block(params["high_res1"], cfg, out, hi_mem, q_valid, hi_valid, q_pos, hi_pe)
    out, hi_mem = _block(params["high_res2"], cfg, out, hi_mem, q_valid, hi_valid, q_pos, hi_pe)

    bbox_tok, score_tok, mask_tok = out[:, 0], out[:, 1], out[:, 2]
    y = _gelu(_lin(params["bbox_fc2"], _gelu(_lin(params["bbox_fc1"], bbox_tok))))
    pred_boxes = torch.sigmoid(_lin(params["bbox_fc3"], y).float())
    pred_score = _lin(params["score"], score_tok).float()

    hs = grid_thw[obj_sample, 1]
    ws = grid_thw[obj_sample, 2]
    mask_hw = torch.stack([hs, ws], dim=-1)
    hc, wc = canvas_hw
    if not compute_mask:
        empty = torch.zeros((n, 4 * hc, 4 * wc), dtype=torch.float32, device=dev)
        return DecoderOutput(pred_boxes, pred_score, empty, mask_hw, obj_valid)

    mo = _gelu(_lin(params["mask_mlp_fc2"], _gelu(_lin(params["mask_mlp_fc1"], mask_tok))))
    mask_output = _lin(params["mask_mlp_fc3"], mo)  # (N, D/16)
    up1 = params["mask_up1"]
    me = _gelu(rms_norm(_lin({"w": up1["w"], "b": up1["b"]}, hi_mem), up1["norm_w"], cfg.rms_norm_eps))
    me = me.reshape(n, s, 2, 2, d // 4)
    me = _gelu(_lin(params["mask_up2"], me))  # (N, S, a, b, D/16*4)
    me = me.reshape(n, s, 2, 2, 2, 2, d // 16).permute(0, 1, 2, 4, 3, 5, 6).reshape(n, s, 4, 4, d // 16)
    logit = torch.einsum("nsrcf,nf->nsrc", me.float(), mask_output.float())
    canvas = assemble_mask_canvas(logit, ws, num_patches[obj_sample], obj_valid, canvas_hw)
    return DecoderOutput(pred_boxes, pred_score, canvas, mask_hw, obj_valid)


def assemble_mask_canvas(logit, ws, n_tokens, obj_valid, canvas_hw: Tuple[int, int]):
    """Token p's 4x4 block -> raster cell (p // W, p % W) of a static
    (N, 4*H_max, 4*W_max) canvas; tokens past n_tokens, invalid objects and
    cells outside the canvas are dropped (JAX's scatter mode="drop")."""
    n, s = logit.shape[:2]
    hc, wc = canvas_hw
    dev = logit.device
    pos = torch.arange(s, device=dev)[None, :]
    w_per = torch.clamp(ws.long(), min=1)[:, None]
    row, col = pos // w_per, pos % w_per
    keep = (pos < n_tokens.long()[:, None]) & obj_valid[:, None] & (row < hc) & (col < wc)
    cell = torch.where(keep, row * wc + col, hc * wc)  # dropped cells land in a spare slot
    canvas = torch.zeros((n, hc * wc + 1, 4, 4), dtype=torch.float32, device=dev)
    canvas.scatter_(1, cell[:, :, None, None].expand(n, s, 4, 4), logit.float())
    canvas = canvas[:, : hc * wc].reshape(n, hc, wc, 4, 4)
    return canvas.permute(0, 1, 3, 2, 4).reshape(n, hc * 4, wc * 4)
