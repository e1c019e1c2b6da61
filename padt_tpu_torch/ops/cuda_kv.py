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

Each wrapper takes the plain PyTorch twin beside it (`*_plain`) for tensors
on the CPU and only there: on a CUDA tensor it launches its kernel or raises.
The twins are the plain branches of the JAX functions
(`decode_attention_int8` :1601-1662 and `_decode_attention_int8_xla` :50,
`_decode_kernel_tiled` :545 for the n_valid form, `decode_attention_int8_multi`
:1426-1451 and :1520-1536, `store_kv_rows_k_all_layers` :924-939) with their
bf16 roundings in the same places; they return the query's dtype.
"""

from __future__ import annotations

import torch

from ._build import check, load_library
from .attention import NEG_INF
from .cuda_attention import _on_cpu, _require, _same_device, _stream

KV_HEAD_DIMS = (16, 32, 64, 128, 256)  # head dims the attention kernel is built for
MAX_STORE_ROWS = 32  # rows per slot that one store writes (the suffix pass width)
_SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use on Hopper

# H4 counts its int8 x int8 score mode (PADT_DECODE_QI8) apart from its bf16 one
launch_counts = {"int8_decode_attn": 0, "int8_decode_attn_qi8": 0, "int8_verify_attn": 0, "store_kv_rows": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


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


_ATTN_ROWS = 8  # query rows per CTA of the attention kernel
_FILL_CTAS = 264  # two CTAs per SM of an H100 (132 SMs)


def _column_split(b: int, hkv: int, rows: int) -> int:
    """CTAs per cluster over the cache columns: doubled from 1 up to 8 while
    the grid has fewer than two CTAs per SM (decode: G = 8 rows per slot and
    kv head; a suffix pass has 32x the rows and keeps 1)."""
    ctas, split = b * hkv * -(-rows // _ATTN_ROWS), 1
    while split < 8 and ctas * split < _FILL_CTAS:
        split *= 2
    return split


def _attn_smem_bytes(c: int, n_fresh: int, hd: int, split: int) -> int:
    """Shared memory of one CTA (`attn_smem_floats` in csrc/int8_kv.cu)."""
    rows, groups, chunk = _ATTN_ROWS, 128 // (hd // 4), -(-c // split)
    return 4 * (rows * hd + rows * (chunk + n_fresh) + groups * rows * hd + rows * hd + 2 * rows + rows * hd // 4 + rows)


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
    n_fresh = 0 if fresh is None else 1
    if fresh is not None:
        _check_fresh(name, fresh, b, hkv, 1, hd)
    if n_valid is not None:
        _int32_rows(name, "n_valid", n_valid, b)
    split = _column_split(b, hkv, g)
    _require(name, _attn_smem_bytes(c, n_fresh, hd, split) <= _SMEM_LIMIT, f"capacity {c} needs more shared memory than a block has")
    out = torch.empty_like(qg)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = load_library()
    rc = lib.padt_int8_decode_attn(
        qg.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(), vs.data_ptr(),
        ptr(k8n), ptr(ksn), ptr(v8n), ptr(vsn), valid.data_ptr(), ptr(n_valid), out.data_ptr(),
        b, hkv, g, c, hd, int(layer), split, int(bool(quantize_q)), hd**-0.5, _stream(qg),
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
    split = _column_split(b, hkv, rows)
    _require(name, _attn_smem_bytes(c, n_fresh, hd, split) <= _SMEM_LIMIT, f"capacity {c} needs more shared memory than a block has")
    out = torch.empty_like(qg)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = load_library()
    rc = lib.padt_int8_verify_attn(
        qg.data_ptr(), k8.data_ptr(), ks.data_ptr(), v8.data_ptr(), vs.data_ptr(),
        ptr(k8n), ptr(ksn), ptr(v8n), ptr(vsn), valid.data_ptr(), None if fresh else write_pos.data_ptr(), out.data_ptr(),
        b, hkv, rows, kq, c, hd, int(layer), split, hd**-0.5, _stream(qg),
    )
    check(lib, name, rc)
    launch_counts[name] += 1
    return out


# ---------------------------------------------------------------------------
# H6 store_kv_rows
# ---------------------------------------------------------------------------

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
    lib = load_library()
    rc = lib.padt_store_kv_rows(
        k8.data_ptr(), ks.data_ptr(), v8.data_ptr(), vs.data_ptr(),
        k8r.data_ptr(), ksr.data_ptr(), v8r.data_ptr(), vsr.data_ptr(),
        pos.data_ptr(), n_rows.data_ptr(), nl, b, hkv, c, kq, hd, _stream(k8),
    )
    check(lib, name, rc)
    launch_counts[name] += 1
