"""Plain float32 reference of PaDT on Qwen2.5-VL: the vision tower, the
visual prototype projection, the extended (text + VRT) vocabulary and the
M-RoPE text stack, teacher-forced over a prompt and the tokens a program
served for it.

Written from the published description (transformers' Qwen2.5-VL modeling
and PaDT's `padt.py`), in plain `torch` operations, with no cache, no
batching across requests and no kernel of the program: it imports nothing
of the program. It reads the weights from the benchmark's own tree (see
`bench_torch/lib/layout.py`), upcast to float32 one layer at a time, so a
whole float32 copy of the model is never held.

Departures from the published modeling, none of which changes a result:
  - windowed attention in the tower is a mask over the merge-block raster
    order (tokens i and j attend when their merged units lie in the same
    112 px window) instead of the window reorder plus `cu_seqlens`;
    attention is permutation-equivariant, so the outputs are the same;
  - a product can be routed through `Precision`, which is how the control
    (the same mathematics in a lower precision) is computed.

Every float32 product runs with TF32 off.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass
class Sample:
    """One served request, as the reference reads it."""

    ids: np.ndarray  # (L,) int: the prompt's real tokens (no padding)
    pixels_u8: np.ndarray  # (S, C*P*P) uint8 patch rows in merge-block raster order
    grid: Sequence[int]  # (t, h, w) in 14 px patches
    served: np.ndarray  # (n,) int: the tokens the program served


class Precision:
    """How a product's operands are rounded before a float32 product.

    `fp32` leaves them as they are. `fp8` rounds both operands to
    float8_e4m3 with a scale per row of the activation and per output
    column of the weight: the step below bfloat16. `int4_weights`
    additionally rounds the text layers' weights to int4 per output column:
    the step below int8 weights."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8", "fp8_int4"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    @staticmethod
    def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
        s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).float() * s

    def weight(self, w: torch.Tensor, text_layer: bool = False) -> torch.Tensor:
        if self.mode == "fp8_int4" and text_layer:
            s = w.abs().amax(dim=0, keepdim=True).clamp(min=1e-30) / 7.0
            return torch.clamp(torch.round(w / s), -7, 7) * s
        return w

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., K) @ w (K, N)."""
        if self.mode == "fp32":
            return x @ w
        return self._fp8(x, -1) @ self._fp8(w, 0)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rotate_half(x):
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def _text_weight(lp: Dict[str, torch.Tensor], name: str, prec: Precision) -> torch.Tensor:
    """A text layer's (in, out) weight in float32, dequantized from int8
    values and per-column scales where the tree holds those."""
    if name + "_q" in lp:
        w = lp[name + "_q"].float() * lp[name + "_s"].float().reshape(1, -1)
    else:
        w = lp[name].float()
    return prec.weight(w, text_layer=True)


# ---------------------------------------------------------------------------
# vision tower
# ---------------------------------------------------------------------------

def _patch_geometry(grid, merge: int, window_units: int, device):
    """Per patch token in merge-block raster order: its row, its column and
    its window id."""
    t, gh, gw = (int(v) for v in grid)
    if t != 1:
        raise ValueError("the reference serves single images (grid t == 1)")
    k = torch.arange(gh * gw, device=device)
    unit, within = k // (merge * merge), k % (merge * merge)
    mw_n = gw // merge
    mh, mw = unit // mw_n, unit % mw_n
    h = mh * merge + within // merge
    w = mw * merge + within % merge
    n_win_w = -(-mw_n // window_units)
    win = (mh // window_units) * n_win_w + mw // window_units
    return h, w, win


def vision_merged(tree, vcfg: Dict, sample: Sample, prec: Precision, device) -> torch.Tensor:
    """(M, out_hidden) merged embeddings in raster order of merged units."""
    d, nh = vcfg["hidden_size"], vcfg["num_heads"]
    hd = d // nh
    merge, ps, tp = vcfg["spatial_merge_size"], vcfg["patch_size"], vcfg["temporal_patch_size"]
    u8 = torch.as_tensor(np.asarray(sample.pixels_u8), device=device)
    s = u8.shape[0]
    c = 3
    mean = torch.tensor(CLIP_MEAN, device=device)[:, None]
    std = torch.tensor(CLIP_STD, device=device)[:, None]
    x = (u8.reshape(s, c, ps * ps).float() / 255.0 - mean) / std
    x = x[:, :, None, :].expand(s, c, tp, ps * ps).reshape(s, c * tp * ps * ps)  # both frames are the image
    x = prec.mm(x, _f32(tree["patch_embed"]["w"]))

    hpos, wpos, win = _patch_geometry(sample.grid, merge, vcfg["window_size"] // (ps * merge), device)
    dim = hd // 2
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, device=device, dtype=torch.float32) / dim))
    freqs = torch.cat([hpos.float()[:, None] * inv, wpos.float()[:, None] * inv], dim=-1)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = emb.cos()[:, None, :], emb.sin()[:, None, :]  # (S, 1, hd)
    same_window = win[:, None] == win[None, :]
    full = set(vcfg["fullatt_block_indexes"])
    eps = vcfg.get("rms_norm_eps", 1e-6)

    blocks = tree["blocks"]
    for li in range(vcfg["depth"]):
        lp = {k: _f32(v[li]) for k, v in blocks.items()}
        xn = rms_norm(x, lp["norm1_w"], eps)
        qkv = (prec.mm(xn, lp["qkv_w"]) + lp["qkv_b"]).reshape(s, 3, nh, hd)
        q, k, v = qkv.unbind(1)
        q, k = q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
        scores = torch.einsum("qhd,khd->hqk", q, k) / hd**0.5
        if li not in full:
            scores = scores.masked_fill(~same_window[None], float("-inf"))
        attn = torch.einsum("hqk,khd->qhd", scores.softmax(-1), v).reshape(s, d)
        x = x + prec.mm(attn, lp["proj_w"]) + lp["proj_b"]
        xn = rms_norm(x, lp["norm2_w"], eps)
        gate = F.silu(prec.mm(xn, lp["gate_w"]) + lp["gate_b"])
        up = prec.mm(xn, lp["up_w"]) + lp["up_b"]
        x = x + prec.mm(gate * up, lp["down_w"]) + lp["down_b"]
        del lp

    mp = tree["merger"]
    y = rms_norm(x, _f32(mp["ln_q_w"]), eps).reshape(s // (merge * merge), merge * merge * d)
    y = F.gelu(prec.mm(y, _f32(mp["fc1"]["w"])) + _f32(mp["fc1"]["b"]), approximate="none")
    return prec.mm(y, _f32(mp["fc2"]["w"])) + _f32(mp["fc2"]["b"])


def prototypes(tree, merged: torch.Tensor, prec: Precision) -> torch.Tensor:
    """PaDT's visual prototype projection: a LayerNorm (eps 1e-5) plus a
    rank-r residual."""
    p = tree["proto"]
    x = F.layer_norm(merged, (merged.shape[-1],), _f32(p["ln_w"]), _f32(p["ln_b"]), eps=1e-5)
    return x + prec.mm(prec.mm(x, _f32(p["down_w"])), _f32(p["up_w"]))


# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------

def mrope_positions(ids: np.ndarray, grid, image_token_id: int, merge: int) -> np.ndarray:
    """(3, L) t/h/w positions, as Qwen2.5-VL's `get_rope_index` gives them
    for one image: text advances all three streams, the image's merged
    units sit at (text position + 0, + row, + column), and the text after
    it resumes at the largest position + 1."""
    ids = np.asarray(ids)
    is_img = ids == image_token_id
    if not is_img.any():
        r = np.arange(len(ids))
        return np.stack([r, r, r])
    first = int(np.argmax(is_img))
    _, gh, gw = (int(v) for v in grid)
    mh, mw = gh // merge, gw // merge
    n_img = mh * mw
    if int(is_img.sum()) != n_img or not is_img[first : first + n_img].all():
        raise ValueError("the image pads are not one run of the image's merged units")
    pre = np.arange(first)
    img_h = np.repeat(np.arange(mh), mw) + first
    img_w = np.tile(np.arange(mw), mh) + first
    img_t = np.full(n_img, first)
    nxt = max(img_h.max(), img_w.max()) + 1
    post = np.arange(len(ids) - first - n_img) + nxt
    return np.concatenate(
        [np.stack([pre, pre, pre]), np.stack([img_t, img_h, img_w]), np.stack([post, post, post])], axis=1
    )


def text_cos_sin(pos: torch.Tensor, head_dim: int, section, theta: float):
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=pos.device, dtype=torch.float64) / head_dim))
    axis = torch.cat([torch.full((w,), a, device=pos.device) for a, w in enumerate(section)])
    freqs = pos.double()[axis].T * inv  # (L, hd/2): slot k reads stream axis[k]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().float()[:, None, :], emb.sin().float()[:, None, :]


def _embed_rows(tree, cfg: Dict, ids: torch.Tensor, merged: torch.Tensor, proto: torch.Tensor) -> torch.Tensor:
    v = cfg["vocab_size"]
    x = _f32(tree["text"]["embed"][ids.clamp(0, v - 1)])
    is_img = ids == cfg["image_token_id"]
    x[is_img] = merged[: int(is_img.sum())]
    is_vrt = ids >= v
    if is_vrt.any():
        x[is_vrt] = proto[ids[is_vrt] - v]
    return x


def served_logits(tree, cfg: Dict, samples: List[Sample], prec: Precision, device) -> List[torch.Tensor]:
    """For each sample, the (n, V + M) float32 logits at the positions that
    predict its n served tokens, teacher-forced over the prompt and the
    served tokens. The layers run one at a time over all samples."""
    tc, vc = cfg, cfg["vision_config"]
    merge = vc["spatial_merge_size"]
    xs, rope, protos, n_merged = [], [], [], []
    for smp in samples:
        merged = vision_merged(tree["vision"], vc, smp, prec, device)
        proto = prototypes(tree, merged, prec)
        seq = np.concatenate([np.asarray(smp.ids), np.asarray(smp.served)[:-1]]).astype(np.int64)
        pos = mrope_positions(np.asarray(smp.ids), smp.grid, cfg["image_token_id"], merge)
        gen = np.arange(len(smp.served) - 1) + pos.max() + 1
        pos = np.concatenate([pos, np.stack([gen, gen, gen])], axis=1)
        ids_t = torch.as_tensor(seq, device=device)
        xs.append(_embed_rows(tree, tc, ids_t, merged, proto))
        rope.append(text_cos_sin(torch.as_tensor(pos, device=device), tc["head_dim"], tc["mrope_section"], tc["rope_theta"]))
        protos.append(proto)
        n_merged.append(merged.shape[0])

    h, hkv, hd = tc["num_attention_heads"], tc["num_key_value_heads"], tc["head_dim"]
    qd, kvd = h * hd, hkv * hd
    eps = tc["rms_norm_eps"]
    layers = tree["text"]["layers"]
    for li in range(tc["num_hidden_layers"]):
        lp = {k: t[li] for k, t in layers.items()}
        qkv_w, qkv_b = _text_weight(lp, "qkv_w", prec), _f32(lp["qkv_b"])
        o_w = _text_weight(lp, "o_w", prec)
        gateup_w, down_w = _text_weight(lp, "gateup_w", prec), _text_weight(lp, "down_w", prec)
        ff = gateup_w.shape[1] // 2
        in_w, post_w = _f32(lp["input_ln_w"]), _f32(lp["post_ln_w"])
        for i, x in enumerate(xs):
            n = x.shape[0]
            cos, sin = rope[i]
            qkv = prec.mm(rms_norm(x, in_w, eps), qkv_w) + qkv_b
            q = qkv[:, :qd].reshape(n, h, hd)
            k = qkv[:, qd : qd + kvd].reshape(n, hkv, hd)
            v = qkv[:, qd + kvd :].reshape(n, hkv, hd)
            q, k = q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
            k, v = k.repeat_interleave(h // hkv, dim=1), v.repeat_interleave(h // hkv, dim=1)
            scores = torch.einsum("qhd,khd->hqk", q, k) / hd**0.5
            causal = torch.ones(n, n, dtype=torch.bool, device=device).tril()
            scores = scores.masked_fill(~causal[None], float("-inf"))
            attn = torch.einsum("hqk,khd->qhd", scores.softmax(-1), v).reshape(n, qd)
            x = x + prec.mm(attn, o_w)
            gu = prec.mm(rms_norm(x, post_w, eps), gateup_w)
            xs[i] = x + prec.mm(F.silu(gu[:, :ff]) * gu[:, ff:], down_w)
        del lp, qkv_w, o_w, gateup_w, down_w

    final_w = _f32(tree["text"]["final_ln_w"])
    head = tree["text"]["embed"] if tc["tie_word_embeddings"] else tree["text"]["lm_head"]
    out = []
    for i, x in enumerate(xs):
        n_served = len(samples[i].served)
        hs = rms_norm(x[-n_served:], final_w, eps)
        lt = torch.cat([prec.mm(hs, _f32(part).T) for part in head.split(32768)], dim=-1)
        lv = prec.mm(hs, protos[i].T)
        out.append(torch.cat([lt, lv[:, : n_merged[i]]], dim=-1))
    return out


def logit_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position: how far the reference's logit of `tokens` lies below
    the reference's best."""
    return ref_logits.max(-1).values - ref_logits.gather(-1, tokens[:, None].long())[:, 0]


def served_gaps(tree, cfg: Dict, samples: List[Sample], device, control: Optional[str] = None):
    """(gaps of the served tokens, gaps of the control's own first choices
    or None) per sample, each a float32 tensor of one value per served
    token. `control` names the lower precision the control computes in."""
    with torch.no_grad():
        ref = served_logits(tree, cfg, samples, Precision("fp32"), device)
        served = [logit_gaps(r, torch.as_tensor(np.asarray(s.served), device=device)) for r, s in zip(ref, samples)]
        if control is None:
            return served, None
        low = served_logits(tree, cfg, samples, Precision(control), device)
        ctrl = [logit_gaps(r, lo.argmax(-1)) for r, lo in zip(ref, low)]
        return served, ctrl
