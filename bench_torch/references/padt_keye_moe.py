"""Plain float32 reference of PaDT on Keye-VL-2.0's sparse-expert text
stack: the tower, the visual prototype projection and the extended (text +
VRT) vocabulary of `padt_qwen25vl.py` (imported from it, so there is one
copy), and the text stack written here from its layer equations, teacher-
forced over a prompt and the tokens a program served for it. Per layer l,
for token x:

    h  = x + o(attn(rope(qn(q(rms(x)))), rope(kn(k(rms(x)))), v(rms(x))))   # no bias
    p  = softmax(rms(h) @ router_w)       # E probabilities, float32
    S  = top-k(p);  w_e = p_e / sum_{e in S} p_e            # norm_topk_prob
    y  = h + sum_{e in S} w_e * down_e(silu(gate_e(rms(h))) * up_e(rms(h)))

`qn` and `kn` are RMSNorms over head_dim on each q and k head (Qwen3-MoE's
`q_norm` / `k_norm`). In plain `torch` operations, with no cache, no
batching across requests and no kernel of the program: it imports nothing
of the program. Each layer's weights are upcast to float32 when the layer
runs (a layer's experts are 2.4 GB in float32), and the experts are
computed one by one over the rows that chose each (index masks).

Departures from the published model, none of which changes a result here:
  - the sparse-attention indexer (`sa_config`, top 2048 keys) is left out:
    the sequences compared are far shorter than 2048 tokens, where it keeps
    every key and attention is exactly dense;
  - the per-head q / k norms are assumed (Qwen3-MoE's block has them;
    config.json does not name them);
  - the tower, prototypes and decoder are PaDT-3B's Qwen2.5-VL ones
    (Keye's own tower is not in its config.json), as in `padt_qwen25vl.py`;
  - every product of the text stack, the router's and attention's two
    included (`padt_qwen25vl.py` leaves attention in float32), goes through
    `Precision`, which is how the control (the same mathematics in a lower
    precision) is computed; in the control the residual stream is also
    rounded after each block, per token, as the program rounds it to bf16
    (fp8 is the step below). With random weights this stack serves few
    distinct tokens at wide margins, and rounding the products alone left
    the control's choices equal to the reference's on some seeds.

Every float32 product runs with TF32 off.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .padt_qwen25vl import (  # noqa: F401  (Sample is the check's input type)
    Precision,
    Sample,
    _embed_rows,
    _f32,
    logit_gaps,
    mrope_positions,
    prototypes,
    rms_norm,
    rotate_half,
    text_cos_sin,
    vision_merged,
)


def _attention(x, lp: Dict[str, torch.Tensor], tc: Dict, cos, sin, prec: Precision) -> torch.Tensor:
    """One sample's causal GQA attention block output (before the
    residual): no bias, per-head q / k RMSNorm before rope."""
    n = x.shape[0]
    h, hkv, hd = tc["num_attention_heads"], tc["num_key_value_heads"], tc["head_dim"]
    qd, kvd = h * hd, hkv * hd
    eps = tc["rms_norm_eps"]
    qkv = prec.mm(rms_norm(x, lp["input_ln_w"], eps), lp["qkv_w"])
    q = rms_norm(qkv[:, :qd].reshape(n, h, hd), lp["q_norm_w"], eps)
    k = rms_norm(qkv[:, qd : qd + kvd].reshape(n, hkv, hd), lp["k_norm_w"], eps)
    v = qkv[:, qd + kvd :].reshape(n, hkv, hd)
    q, k = q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
    k, v = k.repeat_interleave(h // hkv, dim=1), v.repeat_interleave(h // hkv, dim=1)
    # attention's two products take their operands through `prec` too: q and k
    # per head vector, the probabilities per query row, v per column over the keys
    scores = torch.einsum("qhd,khd->hqk", _rounded(prec, q, -1), _rounded(prec, k, -1)) / hd**0.5
    causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal[None], float("-inf"))
    probs = _rounded(prec, scores.softmax(-1), -1)
    attn = torch.einsum("hqk,khd->qhd", probs, _rounded(prec, v, 0)).reshape(n, qd)
    return prec.mm(attn, lp["o_w"])


def _rounded(prec: Precision, t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t` as `prec` rounds a product's operands (a scale along `dim`): an
    operand of attention's products, or the residual stream; as it is in
    float32."""
    return t if prec.mode == "fp32" else Precision._fp8(t, dim)


def routing(xn: torch.Tensor, router_w: torch.Tensor, k: int, norm_topk_prob: bool, prec: Precision):
    """(weights (T, k), expert ids (T, k)) of the router over xn (T, d)."""
    probs = prec.mm(xn, router_w).softmax(-1)
    w, ids = probs.topk(k, dim=-1)
    if norm_topk_prob:
        w = w / w.sum(-1, keepdim=True)
    return w, ids


def moe(xn: torch.Tensor, lp: Dict[str, torch.Tensor], tc: Dict, prec: Precision) -> torch.Tensor:
    """The expert MLP over rows xn (T, d): each expert over the rows that
    chose it, weighted and added into the rows."""
    w, ids = routing(xn, lp["router_w"], tc["num_experts_per_tok"], tc["norm_topk_prob"], prec)
    gate_up, down = lp["experts_gateup_w"], lp["experts_down_w"]
    fe = down.shape[1]
    out = torch.zeros_like(xn)
    for e in range(gate_up.shape[0]):
        rows, slot = (ids == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        gu = prec.mm(xn[rows], gate_up[e])
        y = prec.mm(F.silu(gu[:, :fe]) * gu[:, fe:], down[e])
        out.index_add_(0, rows, y * w[rows, slot][:, None])
    return out


def served_logits(tree, cfg: Dict, samples: List[Sample], prec: Precision, device) -> List[torch.Tensor]:
    """For each sample, the (n, V + M) float32 logits at the positions that
    predict its n served tokens, teacher-forced over the prompt and the
    served tokens. The layers run one at a time over all samples (the
    experts over all samples' rows at once)."""
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
        xs.append(_embed_rows(tree, tc, torch.as_tensor(seq, device=device), merged, proto))
        rope.append(text_cos_sin(torch.as_tensor(pos, device=device), tc["head_dim"], tc["mrope_section"], tc["rope_theta"]))
        protos.append(proto)
        n_merged.append(merged.shape[0])

    eps = tc["rms_norm_eps"]
    sizes = [x.shape[0] for x in xs]
    layers = tree["text"]["layers"]
    for li in range(tc["num_hidden_layers"]):
        lp = {k: _f32(t[li]) for k, t in layers.items()}
        hs = [_rounded(prec, x + _attention(x, lp, tc, *rope[i], prec), -1) for i, x in enumerate(xs)]
        h = torch.cat(hs)
        xs = list(_rounded(prec, h + moe(rms_norm(h, lp["post_ln_w"], eps), lp, tc, prec), -1).split(sizes))
        del lp, hs, h

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
