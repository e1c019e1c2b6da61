"""H4's and H5's launch plan (`ops.cuda_kv.attn_plan`, pure Python) and a
PyTorch emulation of the kernels' order of operations (csrc/int8_kv.cu),
on the CPU.

The plan is checked at every shape the main paths give the two kernels
(PaDT-3B's serve decode, suffix pass and speculative verify; PaDT-7B's
decode; K15's 96 slots at C = 1280) and at the card tests' shapes
(tests/test_torch_kernels.py): every query row and every cache column is
covered exactly once, a cluster holds at most 8 CTAs, the shared memory a
CTA asks for fits a block, and the capacity a block allows is not below
the one of the kernel before (`_old_smem_bytes`).

The emulation follows the kernels step by step: a CTA's columns (its
rank's chunk, cut at n_valid or, under K16's causal limit, at write_pos +
kq) in 64-column tiles, the fresh columns as rank 0's last tiles (H5) or
its one extra column (H4); sweep 1 keeps an online (m, l) per row; the
ranks' (m_k, l_k) combine in rank order; sweep 2 rounds p / l * vs to
bf16 against that global l and sums P.V in fp32; the ranks' rows add in
rank order. It is held to the unchanged plain twins (`int8_*_attn_plain`)
at small serve-like shapes, every valid pattern of the card tests, K15's
rows with no live key and K16's limit, at every column split. Both sides
are float32 on the CPU: the online l differs from the twin's single sum
only in rounding, which can move the bf16 rounding of a p by one ulp, so
the outputs agree within 1e-3 of their largest magnitude (a flip moves an
output by at most 2^-8 of one p * v term); K15's twin rounds in its own
order (K15_TOL)."""

import itertools

import numpy as np
import pytest
import torch

from padt_tpu_torch import padt_3b, padt_7b
from padt_tpu_torch.ops import cuda_kv as K
from padt_tpu_torch.ops.attention import NEG_INF

TILE = K.ATTN_TILE
TOL = 1e-3  # relative to the twin's largest output: a bf16 flip of a p, not a wrong column
# K15's twin rounds p against a running max per 256 columns (K15's own
# order) and rescales its sums, so every P entry rounds differently there
# (not one in many): its outputs agree within 1e-2 of the largest
K15_TOL = 1e-2


def _main_shapes():
    """(kind, B, Hkv, rows, C, hd, n_fresh) of the main paths."""
    c3, c7 = padt_3b().text, padt_7b().text
    g3 = c3.num_attention_heads // c3.num_key_value_heads
    g7 = c7.num_attention_heads // c7.num_key_value_heads
    h3, h7 = c3.num_key_value_heads, c7.num_key_value_heads
    return [
        ("decode", 16, h3, g3, 768, c3.head_dim, 1),  # chip_smoke's serve pool
        ("decode", 8, h3, g3, 768, c3.head_dim, 1),  # the serve engine's 8 slots
        ("decode", 8, h7, g7, 768, c7.head_dim, 1),  # 7B
        ("decode", 16, h3, g3, 768, c3.head_dim, 0),  # K13 / K14
        ("decode", 96, h3, g3, 1280, c3.head_dim, 0),  # K15
        ("verify", 16, h3, g3 * 32, 768, c3.head_dim, 32),  # the suffix pass (K8)
        ("verify", 8, h3, g3 * 32, 768, c3.head_dim, 32),
        ("verify", 16, h3, g3 * 32, 768, c3.head_dim, 0),  # K16
        ("verify", 8, h3, g3 * 4, 768, c3.head_dim, 4),  # speculative verify (draft_k = 4)
    ]


def _card_shapes():
    """The card tests' shapes (tests/test_torch_kernels.py)."""
    out = []
    for b, c, hd in [(5, 197, 128), (16, 768, 128), (5, 131, 64), (5, 7, 128), (5, 127, 128), (5, 128, 128),
                     (5, 129, 128), (5, 197, 16), (5, 197, 256), (3, 20000, 128)]:
        for g, nf in ((8, 1), (7, 1), (8, 0)):
            out.append(("decode", b, 2, g, c, hd, nf))
    for b, c, kq in [(5, 197, 1), (5, 197, 4), (8, 768, 32), (3, 131, 32), (3, 131, 16), (5, 7, 4), (5, 197, 5),
                     (5, 127, 4), (5, 128, 4), (5, 129, 4), (3, 20000, 32)]:
        for hd in (64, 128, 256):
            for nf in (kq, 0):
                out.append(("verify", b, 2, 8 * kq, c, hd, nf))
    out += [("decode", b, 2, 8, c, 128, 0) for b, c in ((5, 512), (96, 1280), (5, 197), (16, 768))]
    return out


SHAPES = _main_shapes() + _card_shapes()


@pytest.mark.parametrize("kind,b,hkv,rows,c,hd,nf", SHAPES)
def test_plan_covers_rows_and_columns_once(kind, b, hkv, rows, c, hd, nf):
    p = K.attn_plan(kind, b, hkv, rows, c, hd, nf)
    assert 1 <= p.split <= K.MAX_SPLIT and p.split & (p.split - 1) == 0 and hd % p.split == 0
    assert p.grid == (p.split * p.row_blocks, hkv, b)
    # rows: row block i holds rows [i R_cta, (i + 1) R_cta), clipped at `rows`
    covered = [0] * rows
    for blk in range(p.row_blocks):
        for r in range(blk * p.rows_per_cta, min(rows, (blk + 1) * p.rows_per_cta)):
            covered[r] += 1
    assert covered == [1] * rows and (p.row_blocks - 1) * p.rows_per_cta < rows
    # columns: the ranks' chunks partition [0, C)
    cols = [0] * c
    for rank in range(p.split):
        c0, c1 = p.columns(rank)
        for col in range(c0, c1):
            cols[col] += 1
    assert cols == [1] * c
    assert p.stages >= 2 and p.smem == K.attn_smem_bytes(kind, hd, p.stages, p.chunk, p.n_fresh, p.row_tiles)
    assert p.row_tiles == 1 or (kind == "verify" and hd <= 128)
    assert p.smem <= K._SMEM_LIMIT


def _old_smem_bytes(c, n_fresh, hd, split):
    """The shared memory of the kernel before this plan (8 query rows a CTA,
    a stored fp32 score row): the capacity limit the plan must not tighten."""
    return 4 * (8 * hd + 8 * (-(-c // split) + n_fresh) + (128 // (hd // 4)) * 8 * hd + 8 * hd + 16 + 8 * hd // 4 + 8)


@pytest.mark.parametrize("kind,hd", list(itertools.product(("decode", "verify"), K.KV_HEAD_DIMS)))
def test_plan_keeps_the_old_capacity(kind, hd):
    """The largest capacity the old kernel took at its one-CTA split still
    fits (two sweeps store no score row, so a block's memory no longer
    bounds the capacity)."""
    nf = 1 if kind == "decode" else 32
    rows = 8 if kind == "decode" else 8 * 32
    c_old = max(c for c in range(64, 8192, 64) if _old_smem_bytes(c, nf, hd, 1) <= K._SMEM_LIMIT)
    for c in (c_old, 4 * c_old):
        p = K.attn_plan(kind, 64, 2, rows, c, hd, nf)
        assert p.smem <= K._SMEM_LIMIT


@pytest.mark.parametrize("kind,b,hkv,rows,c,hd,nf", _main_shapes())
def test_plan_fills_the_card_on_the_main_paths(kind, b, hkv, rows, c, hd, nf):
    """Decode spreads a layer over at least 128 CTAs; a pass at most two
    CTAs an SM; a decode chunk is resident in the ring (every copy issued
    before the first product)."""
    p = K.attn_plan(kind, b, hkv, rows, c, hd, nf)
    if kind == "decode":
        assert p.ctas >= 128 or p.split == K.MAX_SPLIT
        if c <= 768:
            assert all(p.resident(k) for k in range(p.split))
    else:
        assert p.ctas <= 2 * 132 or p.split == 1
        assert p.chunk >= K.VERIFY_MIN_CHUNK or p.split == 1


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------


def _emulate(scores, mask, live, vsl, v8l, split, zero_empty=False, fresh=None):
    """The kernels' order of operations over one layer.

    scores (B, Hkv, R, C) fp32 (dot * ks * scale), mask (B, Hkv, R, C) the
    visible keys, live (B, C) the columns a CTA reads at all (its cut), vsl
    (B, Hkv, C) and v8l (B, Hkv, C, hd). fresh: (s_f (B, Hkv, R, F), its
    visibility, the fresh V operand rule "h5" or "h4", vsn (B, Hkv, F),
    v8n (B, Hkv, F, hd)). Returns fp32 (B, Hkv, R, hd)."""
    bsz, hkv, rows, c = scores.shape
    chunk = -(-c // split)
    neg = torch.tensor(NEG_INF)
    # the kernels' scores: a column a CTA does not read is not a column (-inf)
    x = torch.where(mask, scores, neg)
    x = torch.where(live[:, None, None, :], x, torch.tensor(float("-inf")))
    ms, ls = [], []
    for k in range(split):  # sweep 1, per rank, tile by tile
        c0, c1 = min(c, k * chunk), min(c, (k + 1) * chunk)
        m = torch.full((bsz, hkv, rows), NEG_INF)
        l = torch.zeros((bsz, hkv, rows))
        blocks = [(x[..., t0 : min(c1, t0 + TILE)], mask[..., t0 : min(c1, t0 + TILE)]) for t0 in range(c0, c1, TILE)]
        if fresh is not None and k == 0:
            blocks.append((torch.where(fresh[1], fresh[0], neg), fresh[1]))
        for xb, mb in blocks:
            mn = torch.maximum(m, xb.amax(dim=-1))
            p = torch.exp(xb - mn[..., None])
            if zero_empty:
                p = torch.where(mb, p, 0.0)
            l = l * torch.exp(m - mn) + p.sum(dim=-1)
            m = mn
        ms.append(m)
        ls.append(l)
    m = torch.stack(ms).amax(dim=0)  # the cluster's combine, in rank order
    l = torch.zeros_like(m)
    for mk, lk in zip(ms, ls):
        l = l + lk * torch.exp(mk - m)
    out = torch.zeros((bsz, hkv, rows, v8l.shape[-1]))
    for k in range(split):  # sweep 2, per rank; the ranks' rows add in rank order
        c0, c1 = min(c, k * chunk), min(c, (k + 1) * chunk)
        p = torch.exp(x[..., c0:c1] - m[..., None])
        if zero_empty:
            p = torch.where(mask[..., c0:c1], p, 0.0)
        safe = torch.where(l > 0, l, torch.ones_like(l))[..., None]
        pv = torch.where(l[..., None] > 0, p / safe * vsl[:, :, None, c0:c1], 0.0).to(torch.bfloat16).float()
        part = torch.einsum("bkrc,bkcd->bkrd", pv, v8l[:, :, c0:c1].float())
        if fresh is not None and k == 0:
            s_f, vis_f, rule, vsn, v8n = fresh
            pf = torch.exp(torch.where(vis_f, s_f, neg) - m[..., None]) / safe
            if rule == "h5":
                part = part + torch.einsum("bkrj,bkjd->bkrd", (pf * vsn[:, :, None, :]).to(torch.bfloat16).float(), v8n.float())
            else:
                part = part + pf * (v8n.float() * vsn[..., None])  # H4: fp32, one column
        out = out + part
    return out


def _inputs(seed, b, c, hd, kq, nl=2):
    rng = np.random.RandomState(seed)
    i8 = lambda *s: torch.as_tensor(rng.randint(-127, 128, s).astype(np.int8))
    sc = lambda *s: torch.as_tensor(rng.lognormal(-4, 0.4, s).astype(np.float32))
    hkv = 2
    cache = (i8(nl, b, hkv, c, hd), sc(nl, b, hkv, c), i8(nl, b, hkv, c, hd), sc(nl, b, hkv, c))
    fresh = (i8(b, hkv, kq, hd), sc(b, hkv, kq), i8(b, hkv, kq, hd), sc(b, hkv, kq))
    return rng, cache, fresh


def _valid_patterns(b, c):
    """tests/test_torch_kernels.py's patterns: left padding, an unwritten
    tail, one live row, no live row, every row live."""
    v = torch.zeros((b, c), dtype=torch.bool)
    v[0, 17 : c // 2] = True
    v[1, : c - 3] = True
    v[2, 5] = True
    v[4:] = True
    return v


def _close(out, ref, tol=TOL):
    top = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * top, (err, top)


def _scores(q, k8l, ksl, hd):
    return torch.einsum("bkrd,bkcd->bkrc", q, k8l.float()) * (ksl * hd**-0.5)[:, :, None, :]


@pytest.mark.parametrize("split,fresh", list(itertools.product((1, 2, 4, 8), (True, False))))
def test_emulated_decode_matches_its_twin(split, fresh):
    """H4 with its fresh column (K6) or without (K13 / K14: a slot with no
    valid key gives the mean of the V rows)."""
    b, c, hd, g, layer = 5, 197, 32, 8, 1
    rng, cache, fr = _inputs(split, b, c, hd, 1)
    q = torch.as_tensor((rng.randn(b, 2, g, hd) * 0.5).astype(np.float32)).to(torch.bfloat16).float()
    valid = _valid_patterns(b, c)
    k8l, ksl, v8l, vsl = (t[layer] for t in cache)
    scores = _scores(q, k8l, ksl, hd)
    mask = valid[:, None, None, :].expand(scores.shape)
    fresh_e = None
    if fresh:
        k8n, ksn, v8n, vsn = fr
        s_f = torch.einsum("bkgd,bkrd->bkgr", q, k8n.float()) * (ksn * hd**-0.5)[:, :, None, :]
        fresh_e = (s_f, torch.ones_like(s_f, dtype=torch.bool), "h4", vsn, v8n)
    out = _emulate(scores, mask, torch.ones((b, c), dtype=torch.bool), vsl, v8l, split, fresh=fresh_e)
    ref = K.int8_decode_attn_plain(q, *cache, *(fr if fresh else (None,) * 4), valid, layer)
    _close(out, ref)


@pytest.mark.parametrize("split", (1, 2, 4, 8))
def test_emulated_n_valid_matches_its_twin(split):
    """K15: a CTA reads only the columns below n_valid[b]; a slot with no
    live key gives 0."""
    b, c, hd, g, layer = 6, 512, 32, 8, 0
    rng, cache, _ = _inputs(10 + split, b, c, hd, 1)
    q = torch.as_tensor((rng.randn(b, 2, g, hd) * 0.5).astype(np.float32)).to(torch.bfloat16).float()
    nv = torch.tensor([100, 256, 257, c, 0, 300], dtype=torch.int32)
    cols = torch.arange(c)[None, :]
    valid = (cols < nv[:, None]) & (cols >= 3)
    live = cols < nv[:, None]
    k8l, ksl, v8l, vsl = (t[layer] for t in cache)
    scores = _scores(q, k8l, ksl, hd)
    mask = (valid & live)[:, None, None, :].expand(scores.shape)
    out = _emulate(scores, mask, live, vsl, v8l, split, zero_empty=True)
    ref = K.int8_decode_attn_plain(q, *cache, None, None, None, None, valid, layer, n_valid=nv)
    _close(out, ref, K15_TOL)
    assert out[4].abs().max().item() == 0.0


@pytest.mark.parametrize("split,kq", list(itertools.product((1, 2, 4, 8), (1, 4, 5, 32))))
def test_emulated_verify_matches_its_twin(split, kq):
    """H5 with kq fresh columns, causal inside the block (K8): rank 0's
    last tiles."""
    b, c, hd, g, layer = 5, 197, 32, 2, 1
    rng, cache, fr = _inputs(20 + kq, b, c, hd, kq)
    rows = g * kq
    q = torch.as_tensor((rng.randn(b, 2, rows, hd) * 0.5).astype(np.float32)).to(torch.bfloat16).float()
    valid = _valid_patterns(b, c)
    k8l, ksl, v8l, vsl = (t[layer] for t in cache)
    k8n, ksn, v8n, vsn = fr
    scores = _scores(q, k8l, ksl, hd)
    mask = valid[:, None, None, :].expand(scores.shape)
    s_f = torch.einsum("bkrd,bkjd->bkrj", q, k8n.float()) * (ksn * hd**-0.5)[:, :, None, :]
    vis_f = ((torch.arange(rows) % kq)[:, None] >= torch.arange(kq)[None, :]).expand(s_f.shape)
    out = _emulate(scores, mask, torch.ones((b, c), dtype=torch.bool), vsl, v8l, split,
                   fresh=(s_f, vis_f, "h5", vsn, v8n))
    ref = K.int8_verify_attn_plain(q, *cache, *fr, valid, layer, kq)
    _close(out, ref)


@pytest.mark.parametrize("split,kq", list(itertools.product((1, 2, 4, 8), (4, 16, 32))))
def test_emulated_causal_limit_matches_its_twin(split, kq):
    """K16: no tile past write_pos + kq is read, unless the first query row
    sees no key at all (slot 3: every row then reads the whole cache, whose
    uniform softmax the twin gives)."""
    b, c, hd, g, layer = 5, 197, 32, 2, 0
    rng, cache, _ = _inputs(40 + kq, b, c, hd, kq)
    rows = g * kq
    q = torch.as_tensor((rng.randn(b, 2, rows, hd) * 0.5).astype(np.float32)).to(torch.bfloat16).float()
    wp = torch.tensor([c // 2, 30, c - kq, 1, 0], dtype=torch.int32)
    cols = torch.arange(c)[None, :]
    valid = _valid_patterns(b, c) | ((cols >= wp[:, None]) & (cols < wp[:, None] + kq))
    valid[3] = False  # no key at all: uniform rows
    k8l, ksl, v8l, vsl = (t[layer] for t in cache)
    scores = _scores(q, k8l, ksl, hd)
    rel = (torch.arange(rows) % kq)[None, None, :, None]
    mask = valid[:, None, None, :] & (cols[None, None] <= wp[:, None, None, None] + rel)
    # the kernel's cut: below write_pos + kq where row r % kq == 0 sees a valid column <= write_pos
    sees = torch.stack([valid[i, : int(wp[i]) + 1].any() for i in range(b)])
    live = torch.where(sees[:, None], cols < wp[:, None] + kq, torch.ones_like(cols, dtype=torch.bool))
    out = _emulate(scores, mask, live, vsl, v8l, split)
    ref = K.int8_verify_attn_plain(q, *cache, None, None, None, None, valid, layer, kq, write_pos=wp)
    _close(out, ref)
    mean = (v8l[3].float() * vsl[3][..., None]).mean(dim=1)
    assert (ref[3].float() - mean[:, None]).abs().max().item() < 1e-2 * mean.abs().max().item() + 1e-6


@pytest.mark.parametrize("kind,b,hkv,rows,c,hd,nf", _main_shapes())
def test_sweep_candidates_hold_the_default(kind, b, hkv, rows, c, hd, nf):
    """tools/attn_sweep.py's candidates at a main-path shape: every one fits
    a block, a forced plan keeps its split and stages, and the default plan
    is among them (so the sweep times what the wrappers launch)."""
    from padt_tpu_torch.tools import attn_sweep

    cands = attn_sweep.candidates(kind, b, hkv, rows, c, hd, nf)
    assert cands and all(p.smem <= K._SMEM_LIMIT and p.stages >= 2 for p in cands)
    forced = K.attn_plan(kind, b, hkv, rows, c, hd, nf, split=2, stages=3)
    assert (forced.split, forced.stages) == (2, 3)
    d = K.attn_plan(kind, b, hkv, rows, c, hd, nf)
    assert (d.split, d.stages) in {(p.split, p.stages) for p in cands}
