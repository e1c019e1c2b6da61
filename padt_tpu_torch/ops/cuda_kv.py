"""The int8 KV cache's Hopper kernels, their wrappers, and their plain twins.

| wrapper            | CUDA source     | replaces (padt_tpu/ops/kv_cache.py)                                          |
|--------------------|-----------------|------------------------------------------------------------------------------|
| `int8_decode_attn` | csrc/int8_kv.cu | `_decode_kernel_stacked_fresh` :206 and `_bb` :288 (with `quantize_q`, :173), |
|                    |                 | `_decode_kernel` :87, `_decode_kernel_stacked` :135, `_decode_kernel_tiled` :545 |
| `int8_verify_attn` | csrc/int8_kv.cu | `_decode_kernel_multi_stacked_fresh` :402, `_decode_kernel_multi(_stacked)` :1304, :1340 |
| `store_kv_rows`    | csrc/int8_kv.cu | `_store_rows_kernel_all_layers` :750, `_store_rows_k_kernel_all_layers` :856, |
|                    |                 | `_store_rows_kernel(_stacked)` :662, :683, `_store_rows_k_kernel(_stacked)` :1090, :1220 |

Layout (the JAX package's): k8/v8 (L, B, Hkv, C, hd) int8, ks/vs
(L, B, Hkv, C) fp32 per-token scales, valid (B, C) bool. A single layer, or
an unstacked (B, Hkv, C, hd) cache, is passed as a one-layer view
(`ops.kv_cache` makes the view; nothing is copied).

The attention wrappers take the fresh columns (k8n, ksn, v8n, vsn) or four
Nones: without them H4 reads the cache alone (K13/K14; with `n_valid` only
the columns below n_valid[b], K15) and H5 applies the causal limit
c <= write_pos[b] + r % kq over a cache that already holds the new rows
(K16). `quantize_q` (H4 only) scores with q quantized to int8 per row.

H6 runs one thread per 16-byte chunk of the new rows under programmatic
dependent launch (`store_plan`, a pure-Python mirror of its mapping that
the CPU tests check).

Each wrapper takes the plain PyTorch twin beside it (`*_plain`) for tensors
on the CPU and only there: on a CUDA tensor it launches its kernel or raises.
The twins are the plain branches of the JAX functions
(`decode_attention_int8` :1601-1662 and `_decode_attention_int8_xla` :50,
`_decode_kernel_tiled` :545 for the n_valid form, `decode_attention_int8_multi`
:1426-1451 and :1520-1536, `store_kv_rows_k_all_layers` :924-939) with their
bf16 roundings in the same places; they return the query's dtype.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ._build import check, load_library
from .attention import NEG_INF
from .cuda_attention import SMS, _on_cpu, _require, _same_device, _stream

KV_HEAD_DIMS = (16, 32, 64, 128, 256)  # head dims the attention kernel is built for
MAX_STORE_ROWS = 32  # rows per slot that one store writes (the suffix pass width)
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use on Hopper

# H4 counts its int8 x int8 score mode (PADT_DECODE_QI8) apart from its bf16 one
launch_counts = {"int8_decode_attn": 0, "int8_decode_attn_qi8": 0, "int8_verify_attn": 0, "store_kv_rows": 0}


# H5's launches by kq: speculative verify (kq = draft_k) and suffix passes (kq = 32) apart
verify_launches_by_kq: dict = {}
TALLIES = (launch_counts, verify_launches_by_kq)  # every dict a launch adds to


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    verify_launches_by_kq.clear()


def _check_cache(name, k8, ks, v8, vs, valid, layer: int):
    """Shape, dtype and layout checks shared by the attention wrappers;
    returns (L, B, Hkv, C, hd)."""
    _require(name, k8.dim() == 5 and v8.shape == k8.shape, f"k8/v8 shapes {tuple(k8.shape)} {tuple(v8.shape)}")
    nl, b, hkv, c, hd = k8.shape
    _require(name, k8.dtype == torch.int8 and v8.dtype == torch.int8, "k8/v8 must be int8")
    _require(name, ks.dtype == torch.float32 and vs.dtype == torch.float32, "ks/vs must be fp32")
    _require(name, ks.shape == (nl, b, hkv, c) and vs.shape == ks.shape, f"ks/vs shapes {tuple(ks.shape)}")
    _require(name, valid.dtype == torch.bool and valid.shape == (b, c), f"valid must be bool (B, C), got {valid.dtype} {tuple(valid.shape)}")
    _require(name, hd in KV_HEAD_DIMS, f"head dim {hd} not in {KV_HEAD_DIMS}")
    _require(name, 0 <= layer < nl, f"layer {layer} out of range [0, {nl})")
    for t in (k8, ks, v8, vs, valid):
        _require(name, t.is_contiguous() and t.data_ptr() % 16 == 0, "cache tensors must be contiguous and 16-byte aligned")
    return nl, b, hkv, c, hd


def _int32_rows(name, what, t, b):
    _require(name, t is not None and t.dtype == torch.int32 and t.shape == (b,) and t.is_contiguous(),
             f"{what} must be contiguous int32 (B,)")


def _check_fresh(name, fresh, b, hkv, kq, hd):
    k8n, ksn, v8n, vsn = fresh
    for t8, ts in ((k8n, ksn), (v8n, vsn)):
        _require(name, t8.dtype == torch.int8 and t8.shape == (b, hkv, kq, hd), f"fresh rows must be int8 {(b, hkv, kq, hd)}, got {t8.dtype} {tuple(t8.shape)}")
        _require(name, ts.dtype == torch.float32 and ts.shape == (b, hkv, kq), f"fresh scales must be fp32 {(b, hkv, kq)}")
        _require(name, t8.is_contiguous() and ts.is_contiguous(), "fresh rows and scales must be contiguous")
        _require(name, t8.data_ptr() % 16 == 0, "fresh rows must be 16-byte aligned")


# The attention kernels' launch plan (pure Python, so the CPU tests check it;
# csrc/int8_kv.cu's `verify_smem` / `decode_smem` mirror `attn_smem_bytes`).
ATTN_TILE = 64  # cache columns per tile of the shared-memory ring
ATTN_ROWS = {"decode": 8, "verify": 64}  # query rows per CTA (H5: per row tile): H4's mma n, H5's wgmma m64
MAX_SPLIT = 8  # the largest portable cluster
MAX_STAGES = 5  # ring slots of a streamed (not resident) chunk: the kernel waits with a depth of stages - 2 <= 3
_FILL_CTAS = 264  # two CTAs per SM of an H100 (132 SMs)
VERIFY_MIN_CHUNK = 3 * ATTN_TILE  # H5: the fewest cache columns a split leaves a CTA
VERIFY_ROW_TILES = 2  # H5: 64-row tiles a CTA takes where it can (tools/attn_sweep.py)
_RESIDENT_SMEM = 113 * 1024  # shared memory that leaves room for two CTAs an SM


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def attn_smem_bytes(kind: str, hd: int, stages: int, chunk: int, n_fresh: int = 0, row_tiles: int = 1) -> int:
    """Dynamic shared memory of one CTA: the int8 ring (`stages` slots of a K
    and a V tile, rows padded by 16 bytes), the per-column scales and valid
    bytes of a chunk, and the kernel's own tiles: H5's bf16 q (64 rows a
    row tile), K and V tiles in wgmma's swizzled layout (1024-byte
    aligned) and the cluster's (m, l); H4's q rows (bf16, int8, fp32), the
    transposed V tile, four 8 x 16 P tiles, the rows the cluster folds
    into it and its statistics, the fresh key row."""
    slot = 2 * ATTN_TILE * (hd + 16)
    if kind == "verify":
        cap = _up(chunk, ATTN_TILE) + _up(n_fresh, ATTN_TILE)
        fixed = 1024 + (row_tiles + 2) * 64 * hd * 2 + 4096 * row_tiles
    else:
        cap = _up(chunk, ATTN_TILE)
        fixed = 8 * (hd + 8) * 2 + 8 * (hd + 16) + hd + 8 * hd * 4 + hd * (ATTN_TILE + 8) * 2 + 4 * 8 * 24 * 2 + 16 * hd * 4 + 896
    return fixed + stages * slot + 8 * cap + _up(cap, 16)


@dataclass(frozen=True)
class AttnPlan:
    kind: str  # "decode" (H4) or "verify" (H5)
    b: int
    hkv: int
    rows: int  # query rows of a (slot, kv head): G, or G * kq
    c: int  # cache columns
    n_fresh: int  # fresh columns (rank 0 owns them)
    split: int  # CTAs per cluster over the cache columns
    stages: int  # ring slots
    smem: int  # dynamic shared memory bytes of a CTA
    row_tiles: int = 1  # H5: 64-row tiles a CTA scores against each converted K / V tile

    @property
    def rows_per_cta(self) -> int:
        return ATTN_ROWS[self.kind] * self.row_tiles

    @property
    def row_blocks(self) -> int:
        return -(-self.rows // self.rows_per_cta)

    @property
    def chunk(self) -> int:
        return -(-self.c // self.split)

    @property
    def grid(self):
        return (self.split * self.row_blocks, self.hkv, self.b)

    @property
    def ctas(self) -> int:
        return self.split * self.row_blocks * self.hkv * self.b

    def columns(self, rank: int):
        """[c0, c1): the cache columns rank `rank` of a cluster owns."""
        c0 = min(self.c, rank * self.chunk)
        return c0, min(self.c, c0 + self.chunk)

    def tiles(self, rank: int, n_cols=None) -> int:
        """Ring tiles of rank `rank` over `n_cols` of its columns (all of
        them by default; fewer under n_valid or K16's limit): its cache
        tiles, then the fresh ones (H5's rank 0)."""
        c0, c1 = self.columns(rank)
        n = c1 - c0 if n_cols is None else n_cols
        fresh = self.n_fresh if (rank == 0 and self.kind == "verify") else 0
        return -(-n // ATTN_TILE) + -(-fresh // ATTN_TILE)

    def resident(self, rank: int, n_cols=None) -> bool:
        """Whether the CTA's tiles all fit the ring: then every copy is issued
        before the first product and each tile is read once."""
        return self.tiles(rank, n_cols) <= self.stages


def attn_plan(kind: str, b: int, hkv: int, rows: int, c: int, hd: int, n_fresh: int = 0,
              split: Optional[int] = None, stages: Optional[int] = None, row_tiles: Optional[int] = None) -> AttnPlan:
    """The launch of H4 (kind "decode"; its one fresh column is held apart
    from the tiles) or H5 ("verify"). The column split S doubles from 1:
    H4's while the grid has fewer than two CTAs an SM, then while a CTA's
    chunk does not fit its ring in the shared memory of two CTAs an SM; H5's
    while twice the CTAs still fit two an SM (one, with two row tiles) and
    each CTA keeps at least VERIFY_MIN_CHUNK columns (more, smaller CTAs
    lost to their fixed cost of exchange and fold: PERF.md); and either
    while the CTA needs more shared memory than a block has. The ring holds
    the whole chunk when that fits two CTAs an SM (a block, with two row
    tiles); else H5 streams it through 2 slots and H4 through the most
    (2..MAX_STAGES) that fit. H5 takes VERIFY_ROW_TILES row tiles a
    CTA where a (slot, kv head) has that many (hd <= 128). `split` /
    `stages` / `row_tiles` force a candidate (tools/attn_sweep.py times
    them)."""
    if kind not in ATTN_ROWS:
        raise ValueError(f"unknown attention kernel {kind!r}")
    nf = n_fresh if kind == "verify" else 0
    if row_tiles is None:
        fits = kind == "verify" and hd <= 128 and rows >= VERIFY_ROW_TILES * ATTN_ROWS[kind]
        row_tiles = VERIFY_ROW_TILES if fits else 1
    base = b * hkv * -(-rows // (ATTN_ROWS[kind] * row_tiles))
    forced, forced_stages, split = split, stages, 1
    if kind == "decode":
        while split < MAX_SPLIT and base * split < _FILL_CTAS:
            split *= 2
    else:  # a CTA of two row tiles (8 warps) takes an SM of its own
        while (split < MAX_SPLIT and 2 * base * split <= _FILL_CTAS // row_tiles
               and -(-c // (2 * split)) >= VERIFY_MIN_CHUNK):
            split *= 2

    def stages_for(sp):
        chunk = -(-c // sp)
        tiles = -(-chunk // ATTN_TILE) + -(-nf // ATTN_TILE)
        whole = max(tiles, 2)
        if attn_smem_bytes(kind, hd, whole, chunk, nf, row_tiles) <= (_RESIDENT_SMEM if row_tiles == 1 else _SMEM_LIMIT):
            return whole, True
        if kind == "verify":
            return 2, False
        fit = [s for s in range(2, MAX_STAGES + 1) if attn_smem_bytes(kind, hd, s, chunk, nf) <= _RESIDENT_SMEM]
        return (max(fit) if fit else 2), False

    if forced is not None:
        split = forced
    stages, whole = stages_for(split)
    while forced is None and split < MAX_SPLIT and (
        (kind == "decode" and not whole) or attn_smem_bytes(kind, hd, stages, -(-c // split), nf, row_tiles) > _SMEM_LIMIT
    ):
        split *= 2
        stages, whole = stages_for(split)
    if forced_stages is not None:
        stages = forced_stages
    smem = attn_smem_bytes(kind, hd, stages, -(-c // split), nf, row_tiles)
    return AttnPlan(kind, b, hkv, rows, c, nf, split, stages, smem, row_tiles)


def _check_plan(name, plan, kind, b, hkv, rows, c, n_fresh):
    _require(name, (plan.kind, plan.b, plan.hkv, plan.rows, plan.c, plan.n_fresh) == (kind, b, hkv, rows, c, n_fresh),
             f"the launch plan {plan} is for another call")
    _require(name, plan.split in (1, 2, 4, 8) and plan.stages >= 2 and plan.row_tiles in (1, 2),
             f"split {plan.split} / stages {plan.stages} / row tiles {plan.row_tiles}")
    _require(name, plan.smem <= _SMEM_LIMIT, f"capacity {c} needs more shared memory than a block has")


# ---------------------------------------------------------------------------
# H4 int8_decode_attn
# ---------------------------------------------------------------------------

def quantize_q_rows_plain(q: torch.Tensor):
    """q (..., hd) -> (integer-valued fp32 q8, fp32 scales (...,)): the
    in-kernel row quantization of quantize_q (`_quantize_q_rows` :164), the
    scheme of `quantize_kv`."""
    qf = q.float()
    qs = torch.clamp(qf.abs().amax(dim=-1), min=1e-8) / 127.0
    return torch.clamp(torch.round(qf / qs[..., None]), -127, 127), qs


def _tiled_softmax_pv_plain(scores, mask, vsl, v8l, tile: int = 256):
    """K15's online softmax (`_decode_kernel_tiled` :545) over 256-column
    tiles: p against the running max, masked keys 0, bf16(p * vs) . v8
    accumulated with the running correction, divided by the row sum at the
    end; a row with no visible key gives 0."""
    b, hkv, g, c = scores.shape
    m = torch.full((b, hkv, g, 1), float("-inf"), device=scores.device)
    l = torch.zeros((b, hkv, g, 1), device=scores.device)
    acc = torch.zeros((b, hkv, g, v8l.shape[-1]), device=scores.device)
    for t0 in range(0, c, tile):
        mk = mask[..., t0 : t0 + tile]
        s = torch.where(mk, scores[..., t0 : t0 + tile], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mk, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        pv = (p * vsl[:, :, None, t0 : t0 + tile]).to(torch.bfloat16).float()
        acc = acc * corr + torch.einsum("bkgc,bkcd->bkgd", pv, v8l[:, :, t0 : t0 + tile].float())
        m = m_new
    return torch.where(l > 0, acc / torch.where(l > 0, l, torch.ones_like(l)), 0.0)


def int8_decode_attn_plain(qg, k8, ks, v8, vs, k8n, ksn, v8n, vsn, valid, layer: int, n_valid=None, quantize_q: bool = False):
    k8l, ksl, v8l, vsl = k8[layer], ks[layer], v8[layer], vs[layer]
    scale = 1.0 / (qg.shape[-1] ** 0.5)
    if quantize_q:  # integer-valued fp32 products are exact: the int32 dot
        q8, qsc = quantize_q_rows_plain(qg)
        qe = q8 * qsc[..., None]
        scores = torch.einsum("bkgd,bkcd->bkgc", q8, k8l.float()) * qsc[..., None]
    else:
        qe = qg.to(torch.bfloat16).float()
        scores = torch.einsum("bkgd,bkcd->bkgc", qe, k8l.float())
    scores = scores * (ksl * scale)[:, :, None, :]
    mask = valid[:, None, None, :]
    if n_valid is not None:  # K15: columns at or past n_valid[b] are dead
        live = torch.arange(valid.shape[1], device=valid.device)[None, :] < n_valid[:, None]
        return _tiled_softmax_pv_plain(scores, mask & live[:, None, None, :], vsl, v8l).to(qg.dtype)
    scores = torch.where(mask, scores, NEG_INF)
    if k8n is None:  # K13 / K14: the cache alone
        pv = (torch.softmax(scores, dim=-1) * vsl[:, :, None, :]).to(torch.bfloat16).float()
        return torch.einsum("bkgc,bkcd->bkgd", pv, v8l.float()).to(qg.dtype)
    s_f = torch.einsum("bkgd,bkrd->bkgr", qe, k8n.float()) * (ksn * scale)[:, :, None, :]  # (B, Hkv, G, 1)
    m = torch.maximum(scores.amax(dim=-1, keepdim=True), s_f)
    p = torch.exp(scores - m)
    p_f = torch.exp(s_f - m)
    denom = p.sum(dim=-1, keepdim=True) + p_f
    pv = (p / denom * vsl[:, :, None, :]).to(torch.bfloat16).float()
    out = torch.einsum("bkgc,bkcd->bkgd", pv, v8l.float())
    out = out + (p_f / denom) * (v8n.float() * vsn[:, :, :, None])
    return out.to(qg.dtype)


def int8_decode_attn(
    qg: torch.Tensor,  # (B, Hkv, G, hd): kv head j serves q heads [jG, (j+1)G)
    k8: torch.Tensor,  # (L, B, Hkv, C, hd) int8 (pre-update with fresh columns)
    ks: torch.Tensor,  # (L, B, Hkv, C) fp32
    v8: torch.Tensor,
    vs: torch.Tensor,
    k8n,  # (B, Hkv, 1, hd) int8: the current token's K, or None (no fresh column)
    ksn,  # (B, Hkv, 1) fp32, or None
    v8n,
    vsn,
    valid: torch.Tensor,  # (B, C) bool (without the current position when fresh)
    layer: int,
    n_valid=None,  # (B,) int32: read only the columns below n_valid[b] (K15)
    quantize_q: bool = False,  # score with q quantized to int8 per row
    plan: Optional[AttnPlan] = None,  # attn_plan("decode", ...) unless given
) -> torch.Tensor:
    """One-token GQA attention over layer `layer` of the int8 cache, the
    current token's K/V composited as one extra softmax column when given ->
    (B, Hkv, G, hd) contiguous."""
    name = "int8_decode_attn_qi8" if quantize_q else "int8_decode_attn"
    if _on_cpu(qg, name):
        return int8_decode_attn_plain(qg, k8, ks, v8, vs, k8n, ksn, v8n, vsn, valid, layer, n_valid, quantize_q)
    fresh = None if k8n is None else (k8n, ksn, v8n, vsn)
    _same_device(name, qg.device, k8, ks, v8, vs, valid, n_valid, *(fresh or ()))
    nl, b, hkv, c, hd = _check_cache(name, k8, ks, v8, vs, valid, layer)
    _require(name, qg.dtype == torch.bfloat16 and qg.dim() == 4 and qg.shape[:2] == (b, hkv) and qg.shape[3] == hd,
             f"q must be bf16 (B, Hkv, G, hd), got {qg.dtype} {tuple(qg.shape)}")
    _require(name, qg.is_contiguous(), "q must be contiguous")
    g = qg.shape[2]
    if fresh is not None:
        _check_fresh(name, fresh, b, hkv, 1, hd)
    if n_valid is not None:
        _int32_rows(name, "n_valid", n_valid, b)
        _require(name, fresh is None, "n_valid reads the cache alone (K15): no fresh column")
    plan = plan or attn_plan("decode", b, hkv, g, c, hd)
    _check_plan(name, plan, "decode", b, hkv, g, c, 0)
    out = torch.empty_like(qg)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = load_library()
    rc = lib.padt_int8_decode_attn(
        qg.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(), vs.data_ptr(),
        ptr(k8n), ptr(ksn), ptr(v8n), ptr(vsn), valid.data_ptr(), ptr(n_valid), out.data_ptr(),
        b, hkv, g, c, hd, int(layer), plan.split, plan.stages, int(bool(quantize_q)), hd**-0.5, _stream(qg),
    )
    check(lib, name, rc)
    launch_counts[name] += 1
    return out


# ---------------------------------------------------------------------------
# H5 int8_verify_attn
# ---------------------------------------------------------------------------

def int8_verify_attn_plain(qg, k8, ks, v8, vs, k8n, ksn, v8n, vsn, valid, layer: int, kq: int, write_pos=None):
    k8l, ksl, v8l, vsl = k8[layer], ks[layer], v8[layer], vs[layer]
    rows, c = qg.shape[2], k8l.shape[2]
    scale = 1.0 / (qg.shape[-1] ** 0.5)
    scores = torch.einsum("bkrd,bkcd->bkrc", qg.to(torch.bfloat16).float(), k8l.float()) * (ksl * scale)[:, :, None, :]
    row_i = (torch.arange(rows, device=qg.device) % kq)[:, None]
    if k8n is None:  # K16: row r sees the valid columns c <= write_pos[b] + r % kq
        pos_c = torch.arange(c, device=qg.device)[None, :]
        mask = valid[:, None, None, :] & (pos_c <= write_pos[:, None, None, None] + row_i)
        pv = (torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1) * vsl[:, :, None, :]).to(torch.bfloat16).float()
        return torch.einsum("bkrc,bkcd->bkrd", pv, v8l.float()).to(qg.dtype)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    s_f = torch.einsum("bkrd,bkjd->bkrj", qg.float(), k8n.float()) * (ksn * scale)[:, :, None, :]  # (B, Hkv, R, kq)
    s_f = torch.where(row_i >= torch.arange(kq, device=qg.device)[None, :], s_f, NEG_INF)
    full = torch.cat([scores, s_f], dim=-1)
    p = torch.exp(full - full.amax(dim=-1, keepdim=True))
    probs = p / p.sum(dim=-1, keepdim=True)
    p_c, p_f = probs[..., :c], probs[..., c:]
    # unlike H4, the fresh probabilities round through bf16 like the cache's
    out = torch.einsum("bkrc,bkcd->bkrd", (p_c * vsl[:, :, None, :]).to(torch.bfloat16).float(), v8l.float())
    out = out + torch.einsum("bkrj,bkjd->bkrd", (p_f * vsn[:, :, None, :]).to(torch.bfloat16).float(), v8n.float())
    return out.to(qg.dtype)


def int8_verify_attn(
    qg: torch.Tensor,  # (B, Hkv, G*kq, hd), rows head-major: r = gi*kq + i
    k8: torch.Tensor,  # (L, B, Hkv, C, hd) int8 (pre-update with fresh columns)
    ks: torch.Tensor,
    v8: torch.Tensor,
    vs: torch.Tensor,
    k8n,  # (B, Hkv, kq, hd) int8: the kq new tokens' K, or None
    ksn,  # (B, Hkv, kq) fp32, or None
    v8n,
    vsn,
    valid: torch.Tensor,  # (B, C) bool: without the kq new positions when fresh, with them otherwise
    layer: int,
    kq: int,
    write_pos=None,  # (B,) int32: the first new position, for the causal limit without fresh columns
    plan: Optional[AttnPlan] = None,  # attn_plan("verify", ...) unless given
) -> torch.Tensor:
    """kq-query int8 attention over layer `layer` of the cache; with fresh
    columns, query row r sees fresh column j iff r % kq >= j; without them,
    cache column c iff c <= write_pos[b] + r % kq -> (B, Hkv, G*kq, hd)
    contiguous."""
    name = "int8_verify_attn"
    if _on_cpu(qg, name):
        return int8_verify_attn_plain(qg, k8, ks, v8, vs, k8n, ksn, v8n, vsn, valid, layer, kq, write_pos)
    fresh = None if k8n is None else (k8n, ksn, v8n, vsn)
    _same_device(name, qg.device, k8, ks, v8, vs, valid, write_pos, *(fresh or ()))
    nl, b, hkv, c, hd = _check_cache(name, k8, ks, v8, vs, valid, layer)
    _require(name, qg.dtype == torch.bfloat16 and qg.dim() == 4 and qg.shape[:2] == (b, hkv) and qg.shape[3] == hd,
             f"q must be bf16 (B, Hkv, G*kq, hd), got {qg.dtype} {tuple(qg.shape)}")
    _require(name, qg.is_contiguous(), "q must be contiguous")
    rows = qg.shape[2]
    _require(name, kq >= 1 and rows % kq == 0, f"{rows} query rows are not a multiple of kq={kq}")
    if fresh is None:
        _int32_rows(name, "write_pos (needed without fresh columns)", write_pos, b)
    else:
        _check_fresh(name, fresh, b, hkv, kq, hd)
    n_fresh = 0 if fresh is None else kq
    plan = plan or attn_plan("verify", b, hkv, rows, c, hd, n_fresh)
    _check_plan(name, plan, "verify", b, hkv, rows, c, n_fresh)
    out = torch.empty_like(qg)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = load_library()
    rc = lib.padt_int8_verify_attn(
        qg.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(), vs.data_ptr(),
        ptr(k8n), ptr(ksn), ptr(v8n), ptr(vsn), valid.data_ptr(), None if fresh else write_pos.data_ptr(), out.data_ptr(),
        b, hkv, rows, kq, c, hd, int(layer), plan.split, plan.stages, plan.row_tiles, hd**-0.5, _stream(qg),
    )
    check(lib, name, rc)
    launch_counts[name] += 1
    verify_launches_by_kq[kq] = verify_launches_by_kq.get(kq, 0) + 1
    return out


# ---------------------------------------------------------------------------
# H6 store_kv_rows
# ---------------------------------------------------------------------------

STORE_BLOCKS = (128, 64, 32)  # H6's CTA sizes where the grid gives every SM a CTA, largest first
STORE_RPTS = (2, 1)  # H6's rows per thread (kernel instances), largest first; 4 and 8 lost in the sweep
STORE_PDL = True  # H6 launches under programmatic dependent launch
STORE_SM_THREADS = 2048  # the threads an SM holds at once


@dataclass(frozen=True)
class StorePlan:
    """How csrc/int8_kv.cu's H6 runs one call: one thread per 16-byte chunk
    of `rpt` new K or V rows over `layers` x `b` slots x `hkv` heads x
    `groups` = ceil(kq / rpt) groups of rows, `block` threads a CTA."""

    layers: int
    b: int
    hkv: int
    kq: int
    hd: int
    rpt: int
    block: int
    pdl: bool  # launch under programmatic dependent launch

    @property
    def chunks(self) -> int:
        return self.hd // 16

    @property
    def groups(self) -> int:
        return -(-self.kq // self.rpt)

    @property
    def threads(self) -> int:
        return 2 * self.layers * self.b * self.hkv * self.groups * self.chunks

    @property
    def ctas(self) -> int:
        return -(-self.threads // self.block)

    def units(self, t):
        """(layer, slot, head, row, kv, chunk) of every row the threads t
        (numpy ints below `threads`) copy, by the kernel's own formula:
        thread t takes rows jg * rpt + r (r < rpt, row < kq) of chunk t %
        chunks of the K (kv 0) or V (kv 1) rows."""
        e, u = t % self.chunks, t // self.chunks
        kv, u = u % 2, u // 2
        jg, u = u % self.groups, u // self.groups
        h, u = u % self.hkv, u // self.hkv
        j = (jg[:, None] * self.rpt + np.arange(self.rpt)[None, :]).ravel()
        rep = lambda x: np.repeat(x, self.rpt)
        live = j < self.kq
        return tuple(x[live] for x in (rep(u // self.b), rep(u % self.b), rep(h), j, rep(kv), rep(e)))


def store_plan(layers: int, b: int, hkv: int, kq: int, hd: int, rpt: Optional[int] = None,
               block: Optional[int] = None, pdl: Optional[bool] = None) -> StorePlan:
    """H6's launch plan, from tools/store_rows_times.py's sweep on an H100:
    the most rows a thread (of STORE_RPTS, at most kq) that still fills
    every SM's STORE_SM_THREADS thread slots, else one (3B's suffix store at
    16 slots: 2 rows a thread, 0.0037 ms, against 0.0039-0.0049 at 8, 4 or
    1 in the sweep); the largest of STORE_BLOCKS that still gives every SM
    a CTA, else the smallest (a one-layer store: a few CTAs whichever); programmatic
    dependent launch as STORE_PDL says (3B decode 0.0028 -> 0.0015 ms).
    `rpt` / `block` / `pdl` force a candidate."""
    threads = lambda r: 2 * layers * b * hkv * -(-kq // r) * (hd // 16)
    if rpt is None:
        rpt = next((r for r in STORE_RPTS if r <= kq and threads(r) >= SMS * STORE_SM_THREADS), 1)
    if block is None:
        block = next((c for c in STORE_BLOCKS if -(-threads(rpt) // c) >= SMS), STORE_BLOCKS[-1])
    return StorePlan(layers, b, hkv, kq, hd, rpt, block, STORE_PDL if pdl is None else pdl)


@functools.lru_cache(maxsize=64)
def _default_store_plan(layers: int, b: int, hkv: int, kq: int, hd: int, pdl: bool) -> StorePlan:
    """store_plan's default for a call's shape, made once (a decode step's
    host time bounds it)."""
    return store_plan(layers, b, hkv, kq, hd, pdl=pdl)


def _put_rows(buf, new, j: int, rows, keep):
    """buf[:, b, :, rows[b]] = new[:, b, :, j] where keep[b] (all layers)."""
    bi = torch.arange(buf.shape[1], device=buf.device)
    ri = rows.clamp(0, buf.shape[3] - 1)
    cur = buf[:, bi, :, ri]  # advanced indices first: (B, L, Hkv[, hd])
    nj = new[:, :, :, j].transpose(0, 1)
    m = keep.view(-1, *([1] * (cur.dim() - 1)))
    buf[:, bi, :, ri] = torch.where(m, nj, cur)


def store_kv_rows_plain(k8, ks, v8, vs, k8r, ksr, v8r, vsr, pos, n_rows):
    c = k8.shape[3]
    for j in range(k8r.shape[3]):
        rows = pos.long() + j
        keep = (j < n_rows) & (rows >= 0) & (rows < c)
        for buf, new in ((k8, k8r), (ks, ksr), (v8, v8r), (vs, vsr)):
            _put_rows(buf, new, j, rows, keep)


def store_kv_rows(
    k8: torch.Tensor,  # (L, B, Hkv, C, hd) int8, written in place
    ks: torch.Tensor,  # (L, B, Hkv, C) fp32, written in place
    v8: torch.Tensor,
    vs: torch.Tensor,
    k8r: torch.Tensor,  # (L, B, Hkv, kq, hd) int8: every layer's new rows
    ksr: torch.Tensor,  # (L, B, Hkv, kq) fp32
    v8r: torch.Tensor,
    vsr: torch.Tensor,
    pos: torch.Tensor,  # (B,) int32: first row position per slot
    n_rows: torch.Tensor,  # (B,) int32: rows to write per slot (<= kq)
    plan: Optional[StorePlan] = None,  # store_plan(L, B, Hkv, kq, hd) unless given
) -> None:
    """IN PLACE: rows j < n_rows[b] of every layer's new K/V and scales land
    at cache rows pos[b] + j (one layer, or an unstacked cache, is a
    one-layer view). Rows at or past n_rows[b], and rows whose
    position falls outside [0, C), are never written: the caller clamps its
    positions so that the rows it means to write fit."""
    name = "store_kv_rows"
    if _on_cpu(k8, name):
        return store_kv_rows_plain(k8, ks, v8, vs, k8r, ksr, v8r, vsr, pos, n_rows)
    _same_device(name, k8.device, ks, v8, vs, k8r, ksr, v8r, vsr, pos, n_rows)
    _require(name, k8.dim() == 5 and v8.shape == k8.shape, f"k8/v8 shapes {tuple(k8.shape)} {tuple(v8.shape)}")
    nl, b, hkv, c, hd = k8.shape
    kq = k8r.shape[3] if k8r.dim() == 5 else -1
    _require(name, k8.dtype == torch.int8 and v8.dtype == torch.int8, "k8/v8 must be int8")
    _require(name, k8r.dtype == torch.int8 and v8r.dtype == torch.int8, "k8r/v8r must be int8")
    _require(name, k8r.shape == (nl, b, hkv, kq, hd) and v8r.shape == k8r.shape, f"new rows shape {tuple(k8r.shape)}")
    _require(name, 1 <= kq <= MAX_STORE_ROWS, f"{kq} rows per slot (at most {MAX_STORE_ROWS})")
    _require(name, hd % 16 == 0, f"head dim {hd} is not a multiple of 16")
    for t, shape in ((ks, (nl, b, hkv, c)), (vs, (nl, b, hkv, c)), (ksr, (nl, b, hkv, kq)), (vsr, (nl, b, hkv, kq))):
        _require(name, t.dtype == torch.float32 and t.shape == shape, f"scales must be fp32 {shape}, got {t.dtype} {tuple(t.shape)}")
    for t in (pos, n_rows):
        _require(name, t.dtype == torch.int32 and t.shape == (b,), "pos/n_rows must be int32 (B,)")
    for t in (k8, ks, v8, vs, k8r, ksr, v8r, vsr, pos, n_rows):
        _require(name, t.is_contiguous(), "tensors must be contiguous")
    for t in (k8, v8, k8r, v8r):  # 16-byte row copies; the scales move one word at a time
        _require(name, t.data_ptr() % 16 == 0, "k8/v8 and the new rows must be 16-byte aligned")
    plan = plan or _default_store_plan(nl, b, hkv, kq, hd, STORE_PDL)
    _require(name, (plan.layers, plan.b, plan.hkv, plan.kq, plan.hd) == (nl, b, hkv, kq, hd), f"the launch plan {plan} is for another call")
    _require(name, plan.rpt in STORE_RPTS and plan.block in STORE_BLOCKS, f"plan {plan}")
    lib = load_library()
    rc = lib.padt_store_kv_rows(
        k8.data_ptr(), ks.data_ptr(), v8.data_ptr(), vs.data_ptr(),
        k8r.data_ptr(), ksr.data_ptr(), v8r.data_ptr(), vsr.data_ptr(),
        pos.data_ptr(), n_rows.data_ptr(), nl, b, hkv, c, kq, hd, plan.rpt, plan.block, int(plan.pdl), _stream(k8),
    )
    check(lib, name, rc)
    launch_counts[name] += 1
