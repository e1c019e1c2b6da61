"""The port's three Hopper kernels, their wrappers, and their plain twins.

| wrapper             | CUDA source             | replaces (padt_tpu/ops/pallas_attention.py) |
|---------------------|-------------------------|---------------------------------------------|
| `rope_qk`           | csrc/rope_qk.cu         | `_unpack_rope_kernel`, `_rope_pair_kernel`  |
|                     |                         | and its VJP                                 |
| `segment_flash_fwd` | csrc/segment_flash.cu   | `_vis_fwd_kernel`, `_fwd_kernel`, and the   |
|                     |                         | k-block skip `_kblock_ranges`               |
| `window_slot_attn`  | csrc/window_attn.cu     | `_vis_win_kernel`                           |

H1 and H3 take their launch plans from pure-Python functions beside them
(`rope_plan`, `window_plan`), which the CPU tests check at every main-path
shape; each wrapper also takes a `plan=` to force a candidate.

Each wrapper takes the plain PyTorch twin beside it (`*_plain`) for tensors
on the CPU and only there: on a CUDA tensor it launches its kernel or raises.
It checks device, dtype, shape and strides, allocates the output with
`torch.empty`, launches on the current stream, raises on a CUDA error code,
and adds one to `launch_counts[name]` after the launch.

A kernel writes its output through raw pointers, which autograd cannot see:
on CUDA tensors that require grad (with grad mode on) each wrapper raises
rather than cut the graph. Training reaches H1 and H2 through the autograd
Functions of `ops.attention` (`rope_pair_packed`, `flash_attention`, and
the trained vision tower's `_VisionFlashQKV`), whose forwards run with
grad mode off and whose backwards are kernels too (H1 with the sin
negated; H8/H9 in `cuda_flash_bwd`). H3 has no backward: under grad the
tower's windowed layers take H2 over their window-slot ids instead.

The kernels take bf16 activations (fp32 rope tables, int32 segment ids).
The twins compute in fp32 and return the input's dtype. A query row with no
valid key returns 0 in both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ._build import check, load_library
from .rope import apply_rotary

WINDOW = 64  # tokens per vision window slot (vision_geom.py window_slots)
HEAD_DIMS = (16, 32, 64, 80, 128)  # head dims the attention kernels are built for
BIG_LSE = 1e30  # the LSE of a query row with no visible key: exp(s - lse) is 0

launch_counts = {"rope_qk": 0, "segment_flash_fwd": 0, "window_slot_attn": 0}
# H1's launches split by shape: (rows, q heads, k heads) -> launches
rope_launches_by_shape: dict = {}
TALLIES = (launch_counts, rope_launches_by_shape)  # every dict a launch adds to


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    rope_launches_by_shape.clear()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cpu(t: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (take the twin), False for a CUDA tensor (launch
    the kernel); anything else raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return False


def _require(name: str, ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"{name}: {what}")


def _same_device(name: str, dev: torch.device, *ts) -> None:
    for t in ts:
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on different devices ({t.device} vs {dev})")


def _no_graph_cut(name: str, *ts, hint: str = "call it through its autograd Function in padt_tpu_torch.ops.attention") -> None:
    """Raise for CUDA inputs that autograd would have to differentiate."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts):
        raise RuntimeError(f"{name}: inputs require grad, and the kernel's output would cut the autograd graph; {hint}")


def _vec_ok(t: torch.Tensor) -> bool:
    """16-byte loads: aligned base, unit last stride, other strides multiples of 8."""
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:-1])


# ---------------------------------------------------------------------------
# H1 rope_qk
# ---------------------------------------------------------------------------

def rope_qk_plain(q, k, cos, sin, num_q_heads: int, num_k_heads: int, sin_sign: float = 1.0):
    b, s, _ = q.shape
    hd = cos.shape[-1]
    c, sn = cos[:, :, None, :], sin[:, :, None, :] * sin_sign
    qr = apply_rotary(q.reshape(b, s, num_q_heads, hd), c, sn).reshape(b, s, num_q_heads * hd)
    if k is None:
        return qr, None
    kr = apply_rotary(k.reshape(b, s, num_k_heads, hd), c, sn).reshape(b, s, num_k_heads * hd)
    return qr, kr


def _row_stride(t: torch.Tensor) -> Optional[int]:
    """Element stride between consecutive (batch, seq) rows of a (B, S, W)
    view with unit last stride, or None when rows are not evenly spaced."""
    b, s, _ = t.shape
    if t.stride(2) != 1:
        return None
    rs = t.stride(1) if s > 1 else t.stride(0)
    return rs if (b == 1 or t.stride(0) == s * rs) else None


SMS = 132  # streaming multiprocessors of an H100
SMEM_LIMIT = 232448  # dynamic shared memory a block may use
ROPE_BLOCKS = (128, 64, 32)  # H1's CTA sizes where the grid gives every SM a CTA, largest first
ROPE_DECODE_SMS = 32  # the SMs H1's loads spread over where the grid is too small for all of them
ROPE_HPT = 2  # heads per thread where the grid still gives every SM a CTA of ROPE_BLOCKS[0] threads
PDL = True  # H1 and H3 launch under programmatic dependent launch (tools/rope_window_times.py --sweep)
@dataclass(frozen=True)
class RopePlan:
    """How csrc/rope_qk.cu runs one call: `rows` rows of `heads` (q + k)
    heads of hd; a thread owns one 16-byte vector of 8 pairs (of vecs =
    hd / 16 per half) and applies its tables to `hpt` (1 or 2) heads of its
    row, heads g, g + groups, ...; `block` threads a CTA."""

    rows: int
    heads: int
    hd: int
    hpt: int
    groups: int
    block: int
    pdl: bool = PDL  # launch under programmatic dependent launch

    @property
    def vecs(self) -> int:
        return self.hd // 16

    @property
    def threads(self) -> int:
        return self.rows * self.vecs * self.groups

    @property
    def ctas(self) -> int:
        return -(-self.threads // self.block)

    def units(self):
        """(row, head, vector) numpy arrays of every unit the grid's threads
        take, by the kernel's own mapping (thread t: row t // (vecs * groups),
        group and vector from the rest, heads g + i * groups < heads)."""
        t = np.arange(self.ctas * self.block, dtype=np.int64)
        t = t[t < self.threads]
        per_row = self.vecs * self.groups
        row, u = t // per_row, t % per_row
        g, v = u // self.vecs, u % self.vecs
        h = g[:, None] + np.arange(self.hpt)[None, :] * self.groups
        live = h < self.heads
        n = np.broadcast_to(row[:, None], h.shape)
        return n[live], h[live], np.broadcast_to(v[:, None], h.shape)[live]


def rope_plan(rows: int, heads: int, hd: int, hpt: Optional[int] = None, block: Optional[int] = None,
              pdl: bool = PDL) -> RopePlan:
    """H1's launch plan, from tools/rope_window_times.py's sweep on an H100.
    Heads per thread: ROPE_HPT (the tables read once for two heads) where
    the grid still gives every SM a CTA of ROPE_BLOCKS[0] threads, else 1
    (every decode shape). Block: the largest of ROPE_BLOCKS that gives every
    SM a CTA; where none does (decode: a few rows), 32 or 16 threads,
    whichever spreads the loads over ROPE_DECODE_SMS SMs. Launched under
    programmatic dependent launch. `hpt` / `block` / `pdl` force a
    candidate."""
    vecs = hd // 16
    if hpt is None:
        hpt = ROPE_HPT if rows * vecs * -(-heads // ROPE_HPT) >= SMS * ROPE_BLOCKS[0] else 1
    groups = -(-heads // hpt)
    threads = rows * vecs * groups
    if block is None:
        block = next((c for c in ROPE_BLOCKS if -(-threads // c) >= SMS), None)
        if block is None:
            block = next((c for c in (32, 16) if -(-threads // c) >= ROPE_DECODE_SMS), 16)
    return RopePlan(rows, heads, hd, hpt, groups, block, pdl)


def _aligned_rows(t: torch.Tensor, rs: int) -> bool:
    """16-byte row starts: an aligned base and a row stride of 8 elements."""
    return t.data_ptr() % 16 == 0 and rs % 8 == 0


def rope_qk(
    q: torch.Tensor,  # (B, S, Hq*hd); may be a column view of a wider buffer
    k: Optional[torch.Tensor],  # (B, S, Hk*hd) likewise, or None when Hk == 0
    cos: torch.Tensor,  # (B, S, hd) fp32
    sin: torch.Tensor,
    num_q_heads: int,
    num_k_heads: int,
    sin_sign: float = 1.0,
    plan: Optional[RopePlan] = None,  # rope_plan(B * S, Hq + Hk, hd) unless given
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """fp32 rotate-half rope on the q heads and k heads -> contiguous
    (q_rot (B, S, Hq*hd), k_rot (B, S, Hk*hd) or None). sin_sign -1 rotates
    by the negated angle: the rope's VJP. On the card hd must be a multiple
    of 16 and every row of q, k, cos and sin must start 16-byte aligned."""
    name = "rope_qk"
    if _on_cpu(q, name):
        return rope_qk_plain(q, k, cos, sin, num_q_heads, num_k_heads, sin_sign)
    b, s, _ = q.shape
    hd = cos.shape[-1]
    _same_device(name, q.device, k, cos, sin)
    _no_graph_cut(name, q, k)
    _require(name, sin_sign in (1.0, -1.0), f"sin_sign {sin_sign} is not +-1")
    _require(name, q.dtype == torch.bfloat16 and (k is None or k.dtype == torch.bfloat16), "q/k must be bf16")
    _require(name, cos.dtype == torch.float32 and sin.dtype == torch.float32, "cos/sin must be fp32")
    _require(name, cos.shape == (b, s, hd) and sin.shape == (b, s, hd), f"cos/sin shape {tuple(cos.shape)}")
    _require(name, cos.is_contiguous() and sin.is_contiguous(), "cos/sin must be contiguous")
    _require(name, hd % 16 == 0 and hd > 0, f"head dim {hd} is not a multiple of 16 (16-byte lanes of 8 pairs)")
    _require(name, q.shape[2] == num_q_heads * hd, f"q shape {tuple(q.shape)}")
    _require(name, (k is None) == (num_k_heads == 0), "k is None iff num_k_heads == 0")
    q_rs = _row_stride(q)
    _require(name, q_rs is not None, f"q rows not evenly strided {q.stride()}")
    _require(name, _aligned_rows(q, q_rs), "q rows must start 16-byte aligned (aligned base, row stride a multiple of 8)")
    k_rs = 0
    if k is not None:
        _require(name, k.shape == (b, s, num_k_heads * hd), f"k shape {tuple(k.shape)}")
        k_rs = _row_stride(k)
        _require(name, k_rs is not None, f"k rows not evenly strided {k.stride()}")
        _require(name, _aligned_rows(k, k_rs), "k rows must start 16-byte aligned (aligned base, row stride a multiple of 8)")
    _require(name, cos.data_ptr() % 16 == 0 and sin.data_ptr() % 16 == 0, "cos/sin must be 16-byte aligned")
    rows, heads = b * s, num_q_heads + num_k_heads
    plan = plan or rope_plan(rows, heads, hd)
    _require(name, (plan.rows, plan.heads, plan.hd) == (rows, heads, hd), f"the launch plan {plan} is for another call")
    _require(name, plan.hpt in (1, 2) and plan.hpt * plan.groups >= heads and 0 < plan.block <= 256,
             f"plan {plan}")
    q_out = torch.empty((b, s, num_q_heads * hd), dtype=q.dtype, device=q.device)
    k_out = (
        torch.empty((b, s, num_k_heads * hd), dtype=q.dtype, device=q.device) if k is not None else None
    )
    lib = load_library()
    rc = lib.padt_rope_qk(
        q.data_ptr(), q_rs, None if k is None else k.data_ptr(), k_rs,
        cos.data_ptr(), sin.data_ptr(), q_out.data_ptr(),
        None if k_out is None else k_out.data_ptr(),
        rows, num_q_heads, num_k_heads, hd, plan.hpt, plan.groups, plan.block, int(plan.pdl), float(sin_sign),
        _stream(q),
    )
    check(lib, name, rc)
    launch_counts[name] += 1
    key = (rows, num_q_heads, num_k_heads)
    rope_launches_by_shape[key] = rope_launches_by_shape.get(key, 0) + 1
    return q_out, k_out


# ---------------------------------------------------------------------------
# H2 segment_flash_fwd
# ---------------------------------------------------------------------------

def _masked_softmax_pv(scores: torch.Tensor, mask: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax over the valid keys of each row, then @ v (all fp32); rows
    with no valid key give 0."""
    scores = scores.masked_fill(~mask, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v) / torch.where(l > 0, l, torch.ones_like(l))
    return torch.where(l > 0, out, torch.zeros_like(out))


def visible(q_seg, k_seg, causal: bool) -> torch.Tensor:
    """(B, 1, Sq, Sk) bool: key c visible to query r (segments equal,
    k_seg >= 0, and r >= c when causal)."""
    mask = (q_seg[:, None, :, None] == k_seg[:, None, None, :]) & (k_seg[:, None, None, :] >= 0)
    if causal:
        sq, sk = q_seg.shape[1], k_seg.shape[1]
        mask = mask & torch.ones((sq, sk), dtype=torch.bool, device=q_seg.device).tril()
    return mask


def heads_first(t: torch.Tensor, rep: int = 1) -> torch.Tensor:
    """(B, S, H, hd) -> fp32 (B, H * rep, S, hd), each head repeated `rep`
    times (the GQA map h // rep)."""
    return t.float().permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)


def segment_flash_plain(q, k, v, q_seg, k_seg, causal: bool, scale: float, return_lse: bool = False):
    rep = q.shape[2] // k.shape[2]
    qf, kf, vf = heads_first(q), heads_first(k, rep), heads_first(v, rep)
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    mask = visible(q_seg, k_seg, causal)
    out = _masked_softmax_pv(scores, mask, vf).permute(0, 2, 1, 3).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return out, torch.where(torch.isfinite(lse), lse, torch.full_like(lse, BIG_LSE))


def segment_tiles_plain(q_seg, k_seg, blk_q: int, blk_k: int, causal: bool) -> torch.Tensor:
    """(B, n_qb, n_kb) bool: the key tiles of `blk_k` keys that H2 visits for
    each tile of `blk_q` queries (the kernel's rule at 128 and 128, in
    PyTorch; the kernel decides in its producer warps and never calls this).
    H8 (`flash_bwd_dq`) visits the same at 128 and 64; H9 (`flash_bwd_dkv`)
    visits the transpose at 64 and 128: for each key tile, the query tiles
    marked live (segment_tiles.cuh holds the kernels' one copy of the rule).
    A key tile is live if the interval [lowest, highest] of its valid (>= 0)
    segment ids meets the query tile's, and, when causal, its first key is
    not after the query tile's last row: JAX's per-block test in
    `_kblock_ranges`, without the closure into one [lo, hi) range. Rows past
    the sequence count as segment -1. Every visible (query, key) pair lies in
    a live tile, and the live tiles of a query tile lie in JAX's [lo, hi)."""
    b, sq = q_seg.shape
    sk = k_seg.shape[1]
    n_qb, n_kb = -(-sq // blk_q), -(-sk // blk_k)

    def lo_hi(seg, n, blk):
        tiles = torch.nn.functional.pad(seg, (0, n * blk - seg.shape[1]), value=-1).reshape(b, n, blk)
        lo = torch.where(tiles >= 0, tiles, torch.full_like(tiles, 2**30)).amin(-1)  # no valid id: 2**30
        return lo, tiles.amax(-1)  # no valid id: -1

    (qlo, qhi), (klo, khi) = lo_hi(q_seg, n_qb, blk_q), lo_hi(k_seg, n_kb, blk_k)
    live = (khi[:, None, :] >= qlo[:, :, None]) & (klo[:, None, :] <= qhi[:, :, None])
    if causal:
        first_key = torch.arange(n_kb, device=q_seg.device) * blk_k
        last_row = (torch.arange(n_qb, device=q_seg.device) + 1) * blk_q - 1
        live &= (first_key[None, :] <= last_row[:, None])[None]
    return live


def _tma_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, seq, head) element strides of a (B, S, H, hd) view for a TMA
    descriptor: a dimension of size 1 is never stepped, so its stride, which
    PyTorch leaves arbitrary, is taken as contiguous."""
    b, s, h, d = t.shape
    inner = (s * h * d, h * d, d)
    return tuple(inner[i] if t.shape[i] == 1 else t.stride(i) for i in range(3))


def segment_flash_fwd(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,
    q_seg: torch.Tensor,  # (B, Sq) int32; -1 = pad
    k_seg: torch.Tensor,  # (B, Sk) int32
    causal: bool,
    scale: float,
    return_lse: bool = False,
):
    """Segment-id attention: key c visible to query r iff the segments match
    and k_seg >= 0 (and r >= c when causal); GQA head map h // (H/Hkv).
    Returns contiguous (B, Sq, H, hd), and with return_lse also each row's
    fp32 log-sum-exp (B, H, Sq) of the scaled scores, BIG_LSE on a row with
    no visible key."""
    name = "segment_flash_fwd"
    if _on_cpu(q, name):
        return segment_flash_plain(q, k, v, q_seg, k_seg, causal, scale, return_lse)
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    _same_device(name, q.device, k, v, q_seg, k_seg)
    _no_graph_cut(name, q, k, v)
    _require(name, all(t.dtype == torch.bfloat16 for t in (q, k, v)), "q/k/v must be bf16")
    _require(name, hd in HEAD_DIMS, f"head dim {hd} not in {HEAD_DIMS}")
    _require(name, k.shape == (b, sk, hkv, hd) and v.shape == k.shape, f"k/v shapes {tuple(k.shape)} {tuple(v.shape)}")
    _require(name, hkv > 0 and h % hkv == 0, f"{h} query heads over {hkv} kv heads")
    _require(name, all(_vec_ok(t) for t in (q, k, v)), "q/k/v need unit last stride, 16-byte aligned data and strides that are multiples of 8")
    for seg, n in ((q_seg, sq), (k_seg, sk)):
        _require(name, seg.dtype == torch.int32 and seg.shape == (b, n) and seg.is_contiguous(), "segment ids must be contiguous int32 (B, S)")
    _require(name, not causal or sq == sk, "causal attention needs Sq == Sk")
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if return_lse else None
    lib = load_library()
    rc = lib.padt_segment_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_seg.data_ptr(), k_seg.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, sq, sk, h, hkv, hd,
        *_tma_strides(q), *_tma_strides(k), *_tma_strides(v),
        int(causal), float(scale), _stream(q),
    )
    check(lib, name, rc)
    launch_counts[name] += 1
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------------------
# H3 window_slot_attn
# ---------------------------------------------------------------------------

def window_slot_plain(q, k, v, seg, scale: float):
    b, s, h, d = q.shape
    nw = s // WINDOW
    qw = q.float().reshape(b, nw, WINDOW, h, d).permute(0, 1, 3, 2, 4)  # (B, W, H, win, d)
    kw = k.float().reshape(b, nw, WINDOW, h, d).permute(0, 1, 3, 2, 4)
    vw = v.float().reshape(b, nw, WINDOW, h, d).permute(0, 1, 3, 2, 4)
    scores = torch.matmul(qw, kw.transpose(-1, -2)) * scale
    kvalid = (seg >= 0).reshape(b, nw, 1, 1, WINDOW)
    out = _masked_softmax_pv(scores, kvalid, vw)  # (B, W, H, win, d)
    return out.permute(0, 1, 3, 2, 4).reshape(b, s, h, d).to(q.dtype)


WINDOW_STAGES = 2  # H3's ring stages: one item in flight per consumer warpgroup (always even)
WINDOW_CTAS = SMS  # H3's persistent CTAs: one an SM


def window_smem_bytes(hd: int, stages: int) -> int:
    """Dynamic shared memory of one H3 CTA (Tiles<HD>::smem): the ring of
    Q, K and V tiles, two output staging tiles, the ring's barriers, and
    1024 bytes of alignment slack."""
    tile = WINDOW * hd * 2
    return stages * 3 * tile + 2 * tile + 2 * stages * 8 + 1024


@dataclass(frozen=True)
class WindowPlan:
    """How csrc/window_attn.cu walks one call: `ctas` persistent CTAs over
    the items (slot, head, batch row), item i = r * ctas + cta for r = 0,
    1, ..., taken by consumer warpgroup r % 2 from ring stage r % stages."""

    b: int
    s: int
    h: int
    hd: int
    ctas: int
    stages: int
    pdl: bool = PDL  # launch under programmatic dependent launch

    @property
    def items(self) -> int:
        return self.b * (self.s // WINDOW) * self.h

    @property
    def smem(self) -> int:
        return window_smem_bytes(self.hd, self.stages)

    def coords(self, i: int) -> Tuple[int, int, int]:
        """(slot, head, batch row) of item i, by the kernel's own formula."""
        n_slots = self.s // WINDOW
        return (i // self.h) % n_slots, i % self.h, i // (self.h * n_slots)

    def walk(self, cta: int):
        """[(item, consumer warpgroup, stage)] of CTA `cta`, in its order."""
        return [(i, r % 2, r % self.stages) for r, i in enumerate(range(cta, self.items, self.ctas))]


def window_plan(b: int, s: int, h: int, hd: int, ctas: Optional[int] = None, stages: Optional[int] = None,
                pdl: bool = PDL) -> WindowPlan:
    """H3's launch plan, from tools/rope_window_times.py's sweep on an H100:
    WINDOW_CTAS persistent CTAs (at most one per item), each with a ring of
    WINDOW_STAGES stages, or 2 where those do not fit a block's shared
    memory. The count of stages is even: stage s is read by consumer
    warpgroup s % 2 only (csrc/window_attn.cu). Launched under
    programmatic dependent launch. `ctas` / `stages` / `pdl` force a
    candidate."""
    items = b * (s // WINDOW) * h
    if ctas is None:
        ctas = max(1, min(items, WINDOW_CTAS))
    if stages is None:
        stages = WINDOW_STAGES if window_smem_bytes(hd, WINDOW_STAGES) <= SMEM_LIMIT else 2
    return WindowPlan(b, s, h, hd, ctas, stages, pdl)


def window_slot_attn(
    q: torch.Tensor,  # (B, S, H, hd), S a multiple of 64
    k: torch.Tensor,
    v: torch.Tensor,
    seg: torch.Tensor,  # (B, S) int32; -1 = pad
    scale: float,
    plan: Optional[WindowPlan] = None,  # window_plan(B, S, H, hd) unless given
) -> torch.Tensor:
    """Attention inside each 64-token window slot, keys masked by seg >= 0.
    Returns contiguous (B, S, H, hd)."""
    name = "window_slot_attn"
    if _on_cpu(q, name):
        return window_slot_plain(q, k, v, seg, scale)
    b, s, h, hd = q.shape
    _same_device(name, q.device, k, v, seg)
    _no_graph_cut(name, q, k, v)
    _require(name, all(t.dtype == torch.bfloat16 for t in (q, k, v)), "q/k/v must be bf16")
    _require(name, hd in HEAD_DIMS, f"head dim {hd} not in {HEAD_DIMS}")
    _require(name, s % WINDOW == 0, f"S={s} is not a multiple of {WINDOW}")
    _require(name, k.shape == q.shape and v.shape == q.shape, "q/k/v shapes differ")
    _require(name, all(_vec_ok(t) for t in (q, k, v)), "q/k/v need unit last stride, 16-byte aligned data and strides that are multiples of 8")
    _require(name, seg.dtype == torch.int32 and seg.shape == (b, s) and seg.is_contiguous(), "seg must be contiguous int32 (B, S)")
    _require(name, seg.data_ptr() % 16 == 0, "seg must be 16-byte aligned")
    plan = plan or window_plan(b, s, h, hd)
    _require(name, (plan.b, plan.s, plan.h, plan.hd) == (b, s, h, hd), f"the launch plan {plan} is for another call")
    _require(name, plan.ctas > 0 and plan.stages >= 2 and plan.stages % 2 == 0 and plan.smem <= SMEM_LIMIT,
             f"plan {plan}: the ring needs an even count of stages that fits a block")
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    rc = lib.padt_window_slot_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), out.data_ptr(),
        b, s, h, hd, *_tma_strides(q), *_tma_strides(k), *_tma_strides(v),
        float(scale), plan.ctas, plan.stages, int(plan.pdl), _stream(q),
    )
    check(lib, name, rc)
    launch_counts[name] += 1
    return out
