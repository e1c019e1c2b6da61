"""The flash-attention backward kernels, their wrappers, and their plain twins.

| wrapper          | CUDA source        | replaces (padt_tpu/ops/pallas_attention.py) |
|------------------|--------------------|---------------------------------------------|
| `flash_bwd_dq`   | csrc/flash_bwd.cu  | `_bwd_dq_kernel` :348 (H8)                  |
| `flash_bwd_dkv`  | csrc/flash_bwd.cu  | `_bwd_dkv_kernel` :392 (H9)                 |

Both are bound by tensor-core operations (3 products of length hd per
visible pair and query head in H8, 4 in H9) and are built for Hopper as H2
is: a producer warp streams tiles through a TMA ring under mbarriers, two
consumer warpgroups run the score products as SS-wgmma and the gradient
products as RS-wgmma from registers, and only the tiles whose segment ids
can meet are visited (H2's rule, `segment_tiles_plain`; H9 visits its
transpose). H9 folds the G query heads of a kv head across a thread-block
cluster: each CTA sums its heads' dk / dv in fp32, and after a cluster
barrier each sums its share of rows over the cluster's shared memory in
rank order and casts once. No atomics, so the gradients are the same bits
from run to run. csrc/flash_bwd.cu has the details.

They take what H2's forward saved (`segment_flash_fwd(..., return_lse=True)`)
and the cotangent dO, with delta = rowsum(dO * O) in fp32, and compute what
`_flash_bwd_pallas` computes: p = exp(s * scale - lse) on visible pairs,
dp = dO . v, ds = p * (dp - delta) * scale rounded to the storage dtype
before ds . k and ds^T . q, p rounded to dO's dtype before p^T . dO, GQA
heads folded into dk/dv in fp32 with one final cast.

Each wrapper takes its plain twin for CPU tensors and only there; on CUDA
tensors it checks them, launches on the current stream, raises on a CUDA
error and adds one to `launch_counts[name]`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ._build import check, load_library
from .cuda_attention import HEAD_DIMS, _on_cpu, _require, _same_device, _stream, _vec_ok, heads_first, visible

launch_counts = {"flash_bwd_dq": 0, "flash_bwd_dkv": 0}
TALLIES = (launch_counts,)  # every dict a launch adds to


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _probs_and_ds(q, k, v, g, q_seg, k_seg, lse, delta, causal: bool, scale: float):
    """fp32 (p, ds) over (B, H, Sq, Sk), with the kernels' roundings: p as
    the forward's softmax recomputed from lse, ds rounded to q's dtype."""
    rep = q.shape[2] // k.shape[2]
    s = torch.matmul(heads_first(q), heads_first(k, rep).transpose(-1, -2)) * scale
    mask = visible(q_seg, k_seg, causal)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros((), device=s.device))
    dp = torch.matmul(heads_first(g), heads_first(v, rep).transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    return p, ds


def _fold(t: torch.Tensor, hkv: int, dtype) -> torch.Tensor:
    """(B, H, S, hd) fp32 per query head -> (B, S, Hkv, hd) summed over each
    kv head's group, then cast."""
    b, h, s, d = t.shape
    return t.reshape(b, hkv, h // hkv, s, d).sum(2).permute(0, 2, 1, 3).to(dtype)


def flash_bwd_dq_plain(q, k, v, g, q_seg, k_seg, lse, delta, causal: bool, scale: float):
    _, ds = _probs_and_ds(q, k, v, g, q_seg, k_seg, lse, delta, causal, scale)
    rep = q.shape[2] // k.shape[2]
    return torch.matmul(ds, heads_first(k, rep)).permute(0, 2, 1, 3).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, g, q_seg, k_seg, lse, delta, causal: bool, scale: float):
    p, ds = _probs_and_ds(q, k, v, g, q_seg, k_seg, lse, delta, causal, scale)
    hkv = k.shape[2]
    dk = torch.matmul(ds.transpose(-1, -2), heads_first(q))
    dv = torch.matmul(p.to(g.dtype).float().transpose(-1, -2), heads_first(g))
    return _fold(dk, hkv, k.dtype), _fold(dv, hkv, v.dtype)


def _launch(name: str, q, k, v, g, q_seg, k_seg, lse, delta, outs, causal: bool, scale: float) -> None:
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    _same_device(name, q.device, k, v, g, q_seg, k_seg, lse, delta)
    _require(name, all(t.dtype == torch.bfloat16 for t in (q, k, v, g)), "q/k/v/dO must be bf16")
    _require(name, hd in HEAD_DIMS, f"head dim {hd} not in {HEAD_DIMS}")
    _require(name, g.shape == q.shape, f"dO shape {tuple(g.shape)} != q shape {tuple(q.shape)}")
    _require(name, k.shape == (b, sk, hkv, hd) and v.shape == k.shape, f"k/v shapes {tuple(k.shape)} {tuple(v.shape)}")
    _require(name, hkv > 0 and h % hkv == 0, f"{h} query heads over {hkv} kv heads")
    _require(name, all(_vec_ok(t) for t in (q, k, v, g)), "q/k/v/dO need unit last stride, 16-byte aligned data and strides that are multiples of 8")
    for seg, n in ((q_seg, sq), (k_seg, sk)):
        _require(name, seg.dtype == torch.int32 and seg.shape == (b, n) and seg.is_contiguous(), "segment ids must be contiguous int32 (B, S)")
    for t in (lse, delta):
        _require(name, t.dtype == torch.float32 and t.shape == (b, h, sq) and t.is_contiguous(), "lse/delta must be contiguous fp32 (B, H, Sq)")
    _require(name, not causal or sq == sk, "causal attention needs Sq == Sk")
    lib = load_library()
    strides = [st for t in (q, k, v, g) for st in t.stride()[:3]]
    rc = getattr(lib, "padt_" + name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), q_seg.data_ptr(), k_seg.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
        b, sq, sk, h, hkv, hd, *strides, int(causal), float(scale), _stream(q),
    )
    check(lib, name, rc)
    launch_counts[name] += 1


def flash_bwd_dq(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,
    g: torch.Tensor,  # dO (B, Sq, H, hd)
    q_seg: torch.Tensor,  # (B, Sq) int32
    k_seg: torch.Tensor,  # (B, Sk) int32
    lse: torch.Tensor,  # (B, H, Sq) fp32, from the forward
    delta: torch.Tensor,  # (B, H, Sq) fp32, rowsum(dO * O)
    causal: bool,
    scale: float,
) -> torch.Tensor:
    """dq (B, Sq, H, hd) in q's dtype, contiguous."""
    name = "flash_bwd_dq"
    if _on_cpu(q, name):
        return flash_bwd_dq_plain(q, k, v, g, q_seg, k_seg, lse, delta, causal, scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(name, q, k, v, g, q_seg, k_seg, lse, delta, (dq,), causal, scale)
    return dq


def flash_bwd_dkv(q, k, v, g, q_seg, k_seg, lse, delta, causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each (B, Sk, Hkv, hd) in k's / v's dtype, contiguous; the
    H / Hkv query heads of a group summed in fp32 before the one cast."""
    name = "flash_bwd_dkv"
    if _on_cpu(q, name):
        return flash_bwd_dkv_plain(q, k, v, g, q_seg, k_seg, lse, delta, causal, scale)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch(name, q, k, v, g, q_seg, k_seg, lse, delta, (dk, dv), causal, scale)
    return dk, dv
