"""Sparse experts, as Qwen3-MoE's MLP computes them: the router's softmax
and top-k in float32, the token-expert choices grouped by expert at static
shapes, and the two expert products of H11 (`cuda_moe.expert_matmul` on
the card; the plain twin `expert_matmul_plain` for CPU tensors).

No TPU kernel stands behind this module: the JAX package has no MoE.

Every step here keeps its shapes fixed by the token count alone and reads
nothing back to the host on a CUDA tensor (no `nonzero`, `bincount` or
`.item()`), so a decode step that routes through it can be captured in a
CUDA graph. The grouping is a stable sort of the choices by expert (each
expert's choices in token order). The combine is deterministic: H11's down product writes each choice's row,
scaled by its routing weight, at the choice's own place, and a token's k
rows are summed in one reduction of fixed order (no atomics), so a replay
equals an eager step bit for bit.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from . import cuda_moe
from .cuda_attention import _on_cpu


@dataclass
class Groups:
    """The T x k token-expert choices of one MoE layer in expert order."""

    src: torch.Tensor  # (N,) int32: the token row of each choice
    dst: torch.Tensor  # (N,) int32: each choice's flat index t * k + j
    scale: torch.Tensor  # (N,) fp32: its routing weight
    ends: torch.Tensor  # (E,) int32: inclusive running count of choices per expert
    k: int


@dataclass
class Tally:
    """Device counters of the expert choices of real tokens: `counts` (L, E)
    int32 gathers one forward's choices per (layer, expert); `fold` adds
    their number and the (layer, expert) pairs they hit to `totals` (2,)
    int64 and clears `counts` for the next forward."""

    counts: torch.Tensor
    totals: torch.Tensor

    def fold(self) -> None:
        self.totals.add_(torch.stack((self.counts.sum(), (self.counts > 0).sum())))
        self.counts.zero_()


def route(xn: torch.Tensor, router_w: torch.Tensor, k: int, norm_topk_prob: bool):
    """xn (T, d) @ router_w (d, E) in float32, softmax, top-k -> (weights
    (T, k) fp32, expert ids (T, k) int64), largest first; with
    `norm_topk_prob` the k weights are divided by their sum, which is the
    softmax of the k largest logits (computed so)."""
    logits = xn.float() @ router_w.float()
    if norm_topk_prob:
        top, ids = logits.topk(k, dim=-1)
        return top.softmax(-1), ids
    return logits.softmax(-1).topk(k, dim=-1)


def group(w: torch.Tensor, ids: torch.Tensor, n_experts: int) -> Groups:
    """Choices (T, k) -> `Groups`: a stable sort of the flat choices by
    expert, and each expert's inclusive end (the choices of an expert
    below it or equal) by a search of the sorted ids."""
    k = ids.shape[1]
    sorted_ids, order = torch.sort(ids.reshape(-1), stable=True)
    bounds = torch.arange(1, n_experts + 1, device=ids.device, dtype=sorted_ids.dtype)
    ends = torch.searchsorted(sorted_ids, bounds, out_int32=True)
    dst = order.int()
    return Groups(src=dst // k, dst=dst, scale=w.reshape(-1)[order], ends=ends, k=k)


def count_choices(counts: torch.Tensor, ids: torch.Tensor, real: torch.Tensor) -> None:
    """Add to `counts` (E,) int32 the choices (`ids` (T, k)) of the real
    tokens (`real` (T,) bool), on the device (an integer scatter-add: the
    same sums in any order)."""
    counts.scatter_add_(0, ids.reshape(-1), real[:, None].expand(ids.shape).reshape(-1).int())


def expert_matmul_plain(a: torch.Tensor, w: torch.Tensor, g: Groups, mode: str) -> torch.Tensor:
    """H11's twin, expert by expert in float32, rounded once to a's dtype.
    "gateup": a (T, K) token rows, w (E, K, 2F) gate | up -> (N, F) in
    expert order: silu(a[src] @ gate_e) * (a[src] @ up_e). "down": a (N, K)
    in expert order, w (E, K, D) -> (N, D), row i at `dst[i]`:
    (a_i @ w_e) * scale_i."""
    n = g.src.numel()
    ends = g.ends.tolist()
    cols = w.shape[2] // 2 if mode == "gateup" else w.shape[2]
    out = torch.zeros((n, cols), dtype=a.dtype, device=a.device)
    for e, (s, t) in enumerate(zip([0] + ends[:-1], ends)):
        if s == t:
            continue
        if mode == "gateup":
            y = a[g.src[s:t].long()].float() @ w[e].float()
            out[s:t] = (F.silu(y[:, :cols]) * y[:, cols:]).to(a.dtype)
        else:
            y = (a[s:t].float() @ w[e].float()) * g.scale[s:t, None]
            out[g.dst[s:t].long()] = y.to(a.dtype)
    return out


def expert_matmul(a: torch.Tensor, w: torch.Tensor, g: Groups, mode: str) -> torch.Tensor:
    """One of the two expert products (see `expert_matmul_plain`): the
    twin for CPU tensors, H11 for CUDA tensors."""
    if mode not in ("gateup", "down"):
        raise ValueError(f"unknown expert product {mode!r}")
    if _on_cpu(a, "expert_matmul"):
        return expert_matmul_plain(a, w, g, mode)
    return cuda_moe.expert_matmul(a, w, g, mode)


def moe_mlp(
    xn: torch.Tensor,  # (..., d): the post-attention norm's output
    router_w: torch.Tensor,  # (d, E)
    gateup_w: torch.Tensor,  # (E, d, 2F)
    down_w: torch.Tensor,  # (E, F, d)
    k: int,
    norm_topk_prob: bool,
    real: Optional[torch.Tensor] = None,  # (...) bool: the tokens `counts` counts
    counts: Optional[torch.Tensor] = None,  # (E,) int32: += the real tokens' choices of each expert
    rec=None,
) -> torch.Tensor:
    """Σ_{e in top-k} w_e · down_e(silu(gate_e(xn)) * up_e(xn)) for every
    token, in xn's dtype. Host spans `moe.route` (router, softmax, top-k,
    grouping) and `moe.experts` (the two products and the combine) go to
    `rec` where given."""
    shape = xn.shape
    x2 = xn.reshape(-1, shape[-1])
    with _span(rec, "moe.route"):
        w, ids = route(x2, router_w, k, norm_topk_prob)
        g = group(w, ids, router_w.shape[1])
        if counts is not None:
            count_choices(counts, ids, real.reshape(-1))
    with _span(rec, "moe.experts"):
        h = expert_matmul(x2, gateup_w, g, "gateup")
        y = expert_matmul(h, down_w, g, "down")
        return y.view(x2.shape[0], k, -1).sum(1).view(shape)


def _span(rec, name: str):
    return contextlib.nullcontext() if rec is None else rec.span(name)
