"""The port's Hopper kernels vs their plain PyTorch twins, on the card.

These need an NVIDIA GPU with nvcc (the kernels are built from
padt_tpu_torch/csrc at first use) and skip elsewhere. Run them on the card
with `python -m pytest tests/test_torch_kernels.py -q`.

Tolerance 2e-2 absolute on bf16 outputs of magnitude ~1: the kernels round
to bf16 at other places than the fp32 twins (P before P.V, the output) and
sum in another order."""

import math

import pytest
import torch

from padt_tpu_torch.models.vision_geom import vision_geometry
from padt_tpu_torch.ops import cuda_attention as C

pytestmark = pytest.mark.cuda

TOL = 2e-2


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(g, shape, dev, scale=0.5):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _tables(b, s, hd, dev, g):
    pos = torch.randint(0, 64, (b, s), generator=g, device=dev)
    from padt_tpu_torch.ops.rope import vision_rope_cos_sin

    return vision_rope_cos_sin(pos, pos.flip(-1), hd)


@pytest.mark.parametrize("b,s,hq,hk,hd,fused", [(2, 300, 4, 4, 80, True), (2, 77, 4, 2, 128, False), (3, 1, 4, 2, 128, False)])
def test_rope_qk_matches_plain(dev, b, s, hq, hk, hd, fused):
    g = torch.Generator(device=dev).manual_seed(0)
    cos, sin = _tables(b, s, hd, dev, g)
    if fused:  # q/k as column views of a fused (B, S, 3*H*hd) buffer
        qkv = _randn(g, (b, s, (hq + 2 * hk) * hd), dev)
        q, k = qkv[..., : hq * hd], qkv[..., hq * hd : (hq + hk) * hd]
    else:
        q, k = _randn(g, (b, s, hq * hd), dev), _randn(g, (b, s, hk * hd), dev)
    n0 = C.launch_counts["rope_qk"]
    qr, kr = C.rope_qk(q, k, cos, sin, hq, hk)
    torch.cuda.synchronize()
    assert C.launch_counts["rope_qk"] == n0 + 1
    pq, pk = C.rope_qk_plain(q, k, cos, sin, hq, hk)
    assert _err(qr, pq) < TOL and _err(kr, pk) < TOL
    qo, none = C.rope_qk(q, None, cos, sin, hq, 0)
    assert none is None and _err(qo, pq) < TOL


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_segment_flash_matches_plain(dev, hd, causal):
    g = torch.Generator(device=dev).manual_seed(hd)
    b, s, h, hkv = 2, 203, 4, (2 if causal else 4)
    q = _randn(g, (b, s, h, hd), dev)
    k, v = _randn(g, (b, s, hkv, hd), dev), _randn(g, (b, s, hkv, hd), dev)
    if causal:
        seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
        seg[0, :37] = -1  # left padding
    else:
        seg = torch.sort(torch.randint(0, 3, (b, s), generator=g, device=dev), dim=1).values.int()
        seg[:, -29:] = -1
    out = C.segment_flash_fwd(q, k, v, seg, seg, causal, hd**-0.5)
    torch.cuda.synchronize()
    ref = C.segment_flash_plain(q, k, v, seg, seg, causal, hd**-0.5)
    assert _err(out, ref) < TOL


def test_segment_flash_cross_lengths_and_strided_views(dev):
    """Sq != Sk, and q/k/v as head views of one fused buffer (the vision layout)."""
    g = torch.Generator(device=dev).manual_seed(1)
    b, sq, sk, h, hd = 2, 100, 203, 4, 80
    qkv = _randn(g, (b, sk, 3 * h * hd), dev)
    q = qkv[:, :sq, : h * hd].unflatten(-1, (h, hd))
    k, v = (qkv[..., i * h * hd : (i + 1) * h * hd].unflatten(-1, (h, hd)) for i in (1, 2))
    q_seg = torch.zeros((b, sq), dtype=torch.int32, device=dev)
    k_seg = torch.zeros((b, sk), dtype=torch.int32, device=dev)
    q_seg[1, 90:] = -1
    k_seg[0, 150:] = 1
    out = C.segment_flash_fwd(q, k, v, q_seg, k_seg, False, hd**-0.5)
    torch.cuda.synchronize()
    ref = C.segment_flash_plain(q, k, v, q_seg, k_seg, False, hd**-0.5)
    assert _err(out, ref) < TOL


def _lse_close(lse, ref_lse):
    """The same rows see no key (LSE 1e30), the others within 1e-3 (fp32
    log-sum-exp of bf16 scores)."""
    empty = ref_lse >= 1e29
    assert torch.equal(lse >= 1e29, empty)
    assert not (~empty).any() or (lse - ref_lse)[~empty].abs().max().item() < 1e-3


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_segment_flash_lse_every_head_dim(dev, hd, causal):
    """The LSE output against the twin's at every head dim, causal and not,
    with left padding, a row of batch that is all padding, and S = 333 (not
    a multiple of the 128-row tile)."""
    g = torch.Generator(device=dev).manual_seed(100 + hd)
    b, s, h, hkv = 3, 333, 4, 2
    q = _randn(g, (b, s, h, hd), dev)
    k, v = _randn(g, (b, s, hkv, hd), dev), _randn(g, (b, s, hkv, hd), dev)
    seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
    seg[0, :150] = -1  # the first 128-row query tile sees no key at all
    seg[1, 200:] = 1
    seg[2] = -1
    out, lse = C.segment_flash_fwd(q, k, v, seg, seg, causal, hd**-0.5, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = C.segment_flash_plain(q, k, v, seg, seg, causal, hd**-0.5, return_lse=True)
    assert _err(out, ref) < TOL
    _lse_close(lse, ref_lse)
    assert float(out[seg < 0].float().abs().max()) == 0.0 and bool((lse.transpose(1, 2)[seg < 0] >= 1e29).all())


@pytest.mark.parametrize("hd", [80, 16])
def test_segment_flash_window_slots(dev, hd):
    """H2 over the window-slot layout (seg_win: most key tiles skipped), q/k/v
    as head views of one fused qkv buffer, against the twin, and on the
    valid rows against H3."""
    g = torch.Generator(device=dev).manual_seed(7 + hd)
    b, h = 2, 4
    geo = vision_geometry([(1, 46, 46), (1, 20, 28)], 2304)
    assert geo.pack_index is not None
    seg = torch.as_tensor(geo.seg_win, device=dev)
    s = seg.shape[1]
    qkv = _randn(g, (b, s, 3 * h * hd), dev)
    q, k, v = (qkv[..., i * h * hd : (i + 1) * h * hd].unflatten(-1, (h, hd)) for i in range(3))
    out, lse = C.segment_flash_fwd(q, k, v, seg, seg, False, hd**-0.5, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = C.segment_flash_plain(q, k, v, seg, seg, False, hd**-0.5, return_lse=True)
    assert _err(out, ref) < TOL
    _lse_close(lse, ref_lse)
    valid = seg >= 0  # H3 masks keys only: its pad rows are not 0
    assert _err(out[valid], C.window_slot_attn(q, k, v, seg, hd**-0.5)[valid]) < TOL


@pytest.mark.parametrize("sq,sk,causal", [(333, 333, True), (100, 203, False), (203, 77, False), (1, 300, False), (129, 129, True)])
def test_segment_flash_ragged_lengths(dev, sq, sk, causal):
    """Sq and Sk not multiples of 128, Sq != Sk, one query row; multi-segment
    rows with padding at both ends."""
    g = torch.Generator(device=dev).manual_seed(sq + sk)
    b, h, hkv, hd = 2, 4, 1, 64
    q = _randn(g, (b, sq, h, hd), dev)
    k, v = _randn(g, (b, sk, hkv, hd), dev), _randn(g, (b, sk, hkv, hd), dev)
    segs = [torch.sort(torch.randint(0, 3, (b, n), generator=g, device=dev), dim=1).values.int() for n in (sq, sk)]
    for sg in segs:
        sg[0, : sg.shape[1] // 5] = -1
        sg[1, sg.shape[1] - sg.shape[1] // 7 :] = -1
    out, lse = C.segment_flash_fwd(q, k, v, segs[0], segs[1], causal, hd**-0.5, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = C.segment_flash_plain(q, k, v, segs[0], segs[1], causal, hd**-0.5, return_lse=True)
    assert out.shape == (b, sq, h, hd)
    assert _err(out, ref) < TOL
    _lse_close(lse, ref_lse)


def test_segment_flash_beyond_the_summary_table(dev):
    """B * (query tiles + key tiles) = 72 * 16 past the kernel's table of 1024
    tile summaries: its producer then summarises each tile as it goes."""
    g = torch.Generator(device=dev).manual_seed(72)
    b, s, h, hd = 72, 1024, 1, 64
    q, k, v = (_randn(g, (b, s, h, hd), dev) for _ in range(3))
    seg = torch.sort(torch.randint(0, 3, (b, s), generator=g, device=dev), dim=1).values.int()
    seg[::3, :300] = -1
    out, lse = C.segment_flash_fwd(q, k, v, seg, seg, True, hd**-0.5, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = C.segment_flash_plain(q, k, v, seg, seg, True, hd**-0.5, return_lse=True)
    assert _err(out, ref) < TOL
    _lse_close(lse, ref_lse)


@pytest.mark.parametrize("h,hkv", [(28, 4), (16, 2)])
def test_segment_flash_gqa_groups(dev, h, hkv):
    """GQA at G = 7 (PaDT-7B) and G = 8 (PaDT-3B): causal prefill of 640 with
    left padding; each query head reads its own kv head."""
    g = torch.Generator(device=dev).manual_seed(h)
    b, s, hd = 2, 640, 128
    q = _randn(g, (b, s, h, hd), dev)
    k, v = _randn(g, (b, s, hkv, hd), dev), _randn(g, (b, s, hkv, hd), dev)
    seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
    seg[0, :100] = -1
    out, lse = C.segment_flash_fwd(q, k, v, seg, seg, True, hd**-0.5, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = C.segment_flash_plain(q, k, v, seg, seg, True, hd**-0.5, return_lse=True)
    assert _err(out, ref) < TOL
    _lse_close(lse, ref_lse)


@pytest.mark.parametrize("hd", [16, 80, 128])
def test_window_slot_matches_plain(dev, hd):
    g = torch.Generator(device=dev).manual_seed(hd)
    b, h = 2, 4
    geo = vision_geometry([(1, 20, 28), (1, 14, 14)], 768)
    assert geo.pack_index is not None
    seg = torch.as_tensor(geo.seg_win, device=dev)
    s = seg.shape[1]
    qkv = _randn(g, (b, s, 3 * h * hd), dev)
    q, k, v = (qkv[..., i * h * hd : (i + 1) * h * hd].unflatten(-1, (h, hd)) for i in range(3))
    out = C.window_slot_attn(q, k, v, seg, hd**-0.5)
    torch.cuda.synchronize()
    ref = C.window_slot_plain(q, k, v, seg, hd**-0.5)
    assert _err(out, ref) < TOL


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 64, 2, 16), device=dev)  # float32
    seg = torch.zeros((1, 64), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        C.segment_flash_fwd(q, q, q, seg, seg, False, 0.25)
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 64"):
        C.window_slot_attn(qb[:, :40], qb[:, :40], qb[:, :40], seg[:, :40], 0.25)
    with pytest.raises(ValueError, match="head dim"):
        C.segment_flash_fwd(qb[..., :8], qb[..., :8], qb[..., :8], seg, seg, False, 0.25)


# ---------------------------------------------------------------------------
# int8 KV cache kernels (H4 int8_decode_attn, H5 int8_verify_attn, H6
# store_kv_rows) vs their twins in padt_tpu_torch.ops.cuda_kv
# ---------------------------------------------------------------------------


def _int8_cache(g, dev, nl, b, hkv, c, hd, kq):
    """Random int8 cache (L, B, Hkv, C, hd) with fp32 scales, kq fresh rows."""
    i8 = lambda *s: torch.randint(-127, 128, s, generator=g, device=dev, dtype=torch.int8)
    sc = lambda *s: torch.exp(torch.randn(s, generator=g, device=dev) * 0.4 - 4.0)
    return (i8(nl, b, hkv, c, hd), sc(nl, b, hkv, c), i8(nl, b, hkv, c, hd), sc(nl, b, hkv, c),
            i8(b, hkv, kq, hd), sc(b, hkv, kq), i8(b, hkv, kq, hd), sc(b, hkv, kq))


def _valid_patterns(b, c, dev):
    """One slot per pattern: left padding, an unwritten tail, one live row,
    no live row (only the fresh columns), every row live."""
    v = torch.zeros((b, c), dtype=torch.bool, device=dev)
    v[0, 17 : c // 2] = True
    v[1, : c - 3] = True
    v[2, 5] = True
    v[4:] = True
    return v


@pytest.mark.parametrize("b,c,hd", [(5, 197, 128), (16, 768, 128), (5, 131, 64), (5, 7, 128)])
def test_int8_decode_attn_matches_plain(dev, b, c, hd):
    """Odd capacities (C = 7: some CTAs of a cluster own no column), every
    valid pattern; b=16 is the serve pool's shape."""
    from padt_tpu_torch.ops import cuda_kv as K

    g = torch.Generator(device=dev).manual_seed(c)
    nl, hkv, gq, layer = 3, 2, 8, 1
    k8, ks, v8, vs, kn, ksn, vn, vsn = _int8_cache(g, dev, nl, b, hkv, c, hd, 1)
    q = _randn(g, (b, hkv, gq, hd), dev)
    valid = _valid_patterns(b, c, dev)
    n0 = K.launch_counts["int8_decode_attn"]
    out = K.int8_decode_attn(q, k8, ks, v8, vs, kn, ksn, vn, vsn, valid, layer)
    torch.cuda.synchronize()
    assert K.launch_counts["int8_decode_attn"] == n0 + 1
    ref = K.int8_decode_attn_plain(q, k8, ks, v8, vs, kn, ksn, vn, vsn, valid, layer)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert _err(out, ref) < TOL


@pytest.mark.parametrize("b,c,kq", [(5, 197, 1), (5, 197, 4), (8, 768, 32), (3, 131, 32), (3, 131, 16), (5, 7, 4)])
def test_int8_verify_attn_matches_plain(dev, b, c, kq):
    """kq in {1, 4, 32} (decode width, speculative verify, suffix pass), odd
    capacities, every valid pattern; rows head-major r = gi * kq + i. The
    shapes give column splits (CTAs per cluster) of 8, 1, 2 and 4."""
    from padt_tpu_torch.ops import cuda_kv as K

    g = torch.Generator(device=dev).manual_seed(kq + c)
    nl, hkv, gq, hd, layer = 2, 2, 8, 128, 1
    k8, ks, v8, vs, kn, ksn, vn, vsn = _int8_cache(g, dev, nl, b, hkv, c, hd, kq)
    q = _randn(g, (b, hkv, gq * kq, hd), dev)
    valid = _valid_patterns(b, c, dev)
    out = K.int8_verify_attn(q, k8, ks, v8, vs, kn, ksn, vn, vsn, valid, layer, kq)
    torch.cuda.synchronize()
    ref = K.int8_verify_attn_plain(q, k8, ks, v8, vs, kn, ksn, vn, vsn, valid, layer, kq)
    assert out.shape == q.shape
    assert _err(out, ref) < TOL


@pytest.mark.parametrize("kq", [1, 5, 32])
def test_store_kv_rows_matches_plain(dev, kq):
    """n_rows in {0, partial, kq}, positions at 0, mid-cache, at the callers'
    clamp C - kq and past C - kq (rows beyond C dropped): byte-identical to
    the twin, and a slot with n_rows 0 keeps every byte."""
    from padt_tpu_torch.ops import cuda_kv as K

    g = torch.Generator(device=dev).manual_seed(kq)
    nl, b, hkv, c, hd = 4, 6, 2, 131, 128
    cache = _int8_cache(g, dev, nl, b, hkv, c, hd, 1)[:4]
    new = _int8_cache(g, dev, nl, b, hkv, kq, hd, 1)[:4]  # (L, B, Hkv, kq, hd) rows, (L, B, Hkv, kq) scales
    pos = torch.tensor([0, 40, c - kq, c - kq, c - 1, 77], dtype=torch.int32, device=dev)
    n_rows = torch.tensor([kq, max(kq // 2, 1), kq, 0, kq, 0], dtype=torch.int32, device=dev)
    got = [t.clone() for t in cache]
    ref = [t.clone() for t in cache]
    K.store_kv_rows(*got, *new, pos, n_rows)
    torch.cuda.synchronize()
    K.store_kv_rows_plain(*ref, *new, pos, n_rows)
    for a, r, name in zip(got, ref, ("k8", "ks", "v8", "vs")):
        assert torch.equal(a, r), name
    for s in (3, 5):
        for a, before in zip(got, cache):
            assert torch.equal(a[:, s], before[:, s])
    assert torch.equal(got[0][:, 2, :, c - kq :], new[0][:, 2])


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from padt_tpu_torch.ops import cuda_kv as K

    g = torch.Generator(device=dev).manual_seed(0)
    k8, ks, v8, vs, kn, ksn, vn, vsn = _int8_cache(g, dev, 1, 2, 2, 64, 128, 1)
    valid = torch.ones((2, 64), dtype=torch.bool, device=dev)
    q = _randn(g, (2, 2, 8, 128), dev)
    with pytest.raises(ValueError, match="bf16"):
        K.int8_decode_attn(q.float(), k8, ks, v8, vs, kn, ksn, vn, vsn, valid, 0)
    with pytest.raises(ValueError, match="layer"):
        K.int8_decode_attn(q, k8, ks, v8, vs, kn, ksn, vn, vsn, valid, 1)
    with pytest.raises(ValueError, match="multiple of kq"):
        K.int8_verify_attn(q[:, :, :7].contiguous(), k8, ks, v8, vs, kn, ksn, vn, vsn, valid, 0, 2)
    pos = torch.zeros(2, dtype=torch.int32, device=dev)
    rows = [t[None].expand(1, *t.shape).contiguous() for t in (kn, ksn, vn, vsn)]
    with pytest.raises(ValueError, match="int32"):
        K.store_kv_rows(k8, ks, v8, vs, *rows, pos.long(), pos)


def _live_cache(g, dev, b, c, left=3):
    """Per-slot live lengths at a sub-tile length, a 256-row tile edge, across
    tiles, the full capacity and 0 (a slot with no live key); valid is the
    live range after `left` rows of left padding."""
    lens = torch.tensor([100, 256, 257, c, 0] + [int(x) for x in torch.randint(c // 2, c + 1, (max(b - 5, 0),), generator=g, device=dev)],
                        dtype=torch.int32, device=dev)[:b].clamp(max=c)
    cols = torch.arange(c, device=dev)[None, :]
    return lens.contiguous(), (cols < lens[:, None].long()) & (cols >= left)


@pytest.mark.parametrize("form,b,c", [("cache", 5, 197), ("cache", 16, 768), ("n_valid", 5, 512), ("n_valid", 96, 1280),
                                      ("qi8", 5, 197), ("qi8", 16, 768), ("qi8", 96, 1280)])
def test_int8_decode_forms_match_plain(dev, form, b, c):
    """H4 without its fresh column (K13/K14: every valid pattern, a slot with
    no valid key gives the V rows' mean), with an n_valid bound (K15: the
    lengths of _live_cache, a slot with no live key gives 0), and with int8 x
    int8 scores (K6 under PADT_DECODE_QI8, counted apart); at the test
    sizes, the serve pool's and B = 96, C = 1280."""
    from padt_tpu_torch.ops import cuda_kv as K

    g = torch.Generator(device=dev).manual_seed(b + c)
    nl, hkv, gq, hd, layer = 2, 2, 8, 128, 1
    k8, ks, v8, vs, kn, ksn, vn, vsn = _int8_cache(g, dev, nl, b, hkv, c, hd, 1)
    q = _randn(g, (b, hkv, gq, hd), dev)
    fresh, nv, qi8 = (None,) * 4, None, form == "qi8"
    valid = _valid_patterns(b, c, dev)
    if form == "n_valid":
        nv, valid = _live_cache(g, dev, b, c)
    if qi8:
        fresh = (kn, ksn, vn, vsn)
    key = "int8_decode_attn_qi8" if qi8 else "int8_decode_attn"
    n0 = K.launch_counts[key]
    out = K.int8_decode_attn(q, k8, ks, v8, vs, *fresh, valid, layer, n_valid=nv, quantize_q=qi8)
    torch.cuda.synchronize()
    assert K.launch_counts[key] == n0 + 1
    ref = K.int8_decode_attn_plain(q, k8, ks, v8, vs, *fresh, valid, layer, n_valid=nv, quantize_q=qi8)
    assert _err(out, ref) < TOL
    if qi8:  # within one bf16 ulp of the largest output, and far nearer its twin than the bf16-score twin
        top = ref.float().abs().max().item()
        assert _err(out, ref) <= 2.0 ** (math.floor(math.log2(top)) - 7)
        bf16 = K.int8_decode_attn_plain(q, k8, ks, v8, vs, *fresh, valid, layer)
        gap = lambda a, b: (a.float() - b.float()).abs().mean().item()
        assert gap(out, ref) <= 0.25 * gap(out, bf16)
    if form == "n_valid":
        assert float(out[4].float().abs().max()) == 0.0  # no live key: 0, as K15
    if form == "cache":
        mean = (v8[layer, 3].float() * vs[layer, 3, :, :, None]).mean(dim=1)  # no valid key: uniform softmax
        assert _err(out[3], mean[:, None].expand(hkv, gq, hd)) < TOL


@pytest.mark.parametrize("b,c,kq", [(5, 197, 4), (8, 768, 32), (3, 131, 16), (5, 7, 4)])
def test_int8_verify_without_fresh_matches_plain(dev, b, c, kq):
    """H5 with the causal limit c <= write_pos + r % kq over a cache that
    holds the new rows (K16): write_pos inside a tile, across a tile, at the
    end of the capacity."""
    from padt_tpu_torch.ops import cuda_kv as K

    g = torch.Generator(device=dev).manual_seed(b * kq + c)
    nl, hkv, gq, hd, layer = 2, 2, 8, 128, 0
    k8, ks, v8, vs = _int8_cache(g, dev, nl, b, hkv, c, hd, 1)[:4]
    q = _randn(g, (b, hkv, gq * kq, hd), dev)
    wp = torch.tensor([max(c // 2, 0), 30, c - kq, 1, 0][:b] + [0] * max(b - 5, 0), dtype=torch.int32, device=dev).clamp(min=0)
    valid = _valid_patterns(b, c, dev) | ((torch.arange(c, device=dev)[None, :] >= wp[:, None]) & (torch.arange(c, device=dev)[None, :] < wp[:, None] + kq))
    out = K.int8_verify_attn(q, k8, ks, v8, vs, None, None, None, None, valid, layer, kq, write_pos=wp)
    torch.cuda.synchronize()
    ref = K.int8_verify_attn_plain(q, k8, ks, v8, vs, None, None, None, None, valid, layer, kq, write_pos=wp)
    assert _err(out, ref) < TOL


@pytest.mark.parametrize("kq", [1, 32])
def test_single_layer_stores_match_the_cpu(dev, kq):
    """K17 / K18 through `ops.kv_cache` (one-layer views of an unstacked
    cache and of layer 2 of a stack): byte-identical to the same calls on the
    CPU, positions inside a tile, straddling 32-row tiles and at C - kq."""
    from padt_tpu_torch.ops import kv_cache as KC

    g = torch.Generator(device=dev).manual_seed(kq)
    nl, b, hkv, c, hd = 3, 4, 2, 128, 128
    cache = _int8_cache(g, dev, nl, b, hkv, c, hd, kq)
    pos = torch.tensor([3, 30, 64, c - kq], dtype=torch.int32, device=dev)
    store = KC.store_kv_rows if kq == 1 else KC.store_kv_rows_k
    for layer in (None, 2):
        base = [t[0] if layer is None else t for t in cache[:4]]
        got = [t.clone() for t in base]
        ref = [t.cpu().clone() for t in base]
        out = store(*got, *cache[4:], pos, layer=layer)
        torch.cuda.synchronize()
        assert all(o is t for o, t in zip(out, got))  # in place
        store(*ref, *(t.cpu() for t in cache[4:]), pos.cpu(), layer=layer)
        for a, r in zip(got, ref):
            assert torch.equal(a.cpu(), r)


# ---------------------------------------------------------------------------
# H7 int8_matmul vs its twin in padt_tpu_torch.ops.quant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "m,k,n",
    [(1, 96, 64), (7, 96, 96), (65, 160, 96), (130, 128, 320), (8, 3584, 3584), (256, 3584, 4608), (300, 200, 48)],
)
def test_int8_matmul_matches_plain(dev, m, k, n):
    """M, N and K tails (the tiny model's N of 64..320 and K of 96 / 160,
    K = 200 not a multiple of the 64-wide K step), split-K shapes (M = 8 and
    256 at 7B's widths) and one tile per CTA. Tolerance 2e-2 relative to the
    output's largest magnitude: bf16 output rounding and another order of sums."""
    from padt_tpu_torch.ops import cuda_quant as Q
    from padt_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = _randn(g, (m, k), dev)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = torch.exp(torch.randn((1, n), generator=g, device=dev) * 0.3) * (2.0 / (73 * k**0.5))
    n0 = Q.launch_counts["int8_matmul"]
    out = quant.int8_matmul(x, wq, s)
    torch.cuda.synchronize()
    assert Q.launch_counts["int8_matmul"] == n0 + 1
    ref = quant.int8_matmul_plain(x, wq, s)
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    assert _err(out, ref) <= 2e-2 * ref.float().abs().max().item()


def test_int8_matmul_strided_rows_and_leading_dims(dev):
    """x as a column view of a wider buffer (row stride 384) with two leading
    dims: no copy, the same result as the contiguous rows."""
    from padt_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(3)
    buf = _randn(g, (2, 9, 384), dev)
    x = buf[..., 128:256]
    wq = torch.randint(-127, 128, (128, 160), generator=g, device=dev, dtype=torch.int8)
    s = torch.full((1, 160), 1e-3, device=dev)
    out = quant.int8_matmul(x, wq, s)
    torch.cuda.synchronize()
    assert out.shape == (2, 9, 160)
    assert torch.equal(out, quant.int8_matmul(x.contiguous(), wq, s))
    assert _err(out, quant.int8_matmul_plain(x, wq, s)) <= 2e-2 * out.float().abs().max().item()


def test_int8_matmul_refuses_what_the_kernel_does_not_take(dev):
    from padt_tpu_torch.ops import quant

    x = torch.zeros((4, 64), dtype=torch.bfloat16, device=dev)
    wq = torch.zeros((64, 48), dtype=torch.int8, device=dev)
    s = torch.ones((48,), device=dev)
    with pytest.raises(ValueError, match="bf16"):
        quant.int8_matmul(x.float(), wq, s)
    with pytest.raises(ValueError, match="multiple of 8"):
        quant.int8_matmul(x[:, :60], wq[:60, :40], s[:40])
    with pytest.raises(ValueError, match="without a copy"):
        quant.int8_matmul(torch.zeros((4, 2, 64), dtype=torch.bfloat16, device=dev).transpose(0, 1), wq, s)


# ---------------------------------------------------------------------------
# H10 stream_matmul vs its plain version in padt_tpu_torch.ops.matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "m,k,n,fuse,bias",
    [(96, 2048, 2560, True, True), (96, 2048, 2048, False, False), (96, 2048, 22016, True, False),
     (96, 11008, 2048, False, False), (5, 96, 256, True, True), (130, 160, 96, True, False), (300, 200, 48, False, True)],
)
def test_stream_matmul_matches_plain(dev, m, k, n, fuse, bias):
    """The four PaDT-3B decode products at M = 96 (split-K 8, 8, 1 and 16),
    the tiny model's widths, M past one 128-row tile, K = 200 not a multiple
    of the 32-wide K step. Tolerance 2e-2 relative to the output's largest
    magnitude: bf16 output rounding and another order of sums."""
    from padt_tpu_torch.ops import cuda_matmul as CM
    from padt_tpu_torch.ops import matmul as MM

    g = torch.Generator(device=dev).manual_seed(m + k + n)
    nl, li = 3, 2
    x = _randn(g, (m, k), dev)
    w = _randn(g, (nl, k, n), dev, scale=k**-0.5)
    ln = (1.0 + torch.randn((nl, k), generator=g, device=dev) * 0.1).to(torch.bfloat16) if fuse else None
    b = _randn(g, (nl, n), dev, scale=0.1) if bias else None
    n0 = CM.launch_counts["stream_matmul"]
    out = MM.stream_matmul_stacked(x, w, li, ln_w=ln, bias=b)
    torch.cuda.synchronize()
    assert CM.launch_counts["stream_matmul"] == n0 + 1
    ref = MM.stream_matmul_stacked_ref(x, w, li, ln_w=ln, bias=b)
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    assert _err(out, ref) <= 2e-2 * ref.float().abs().max().item()


def test_stream_matmul_layer_tensor_strided_rows_and_refusals(dev):
    """A 0-d tensor layer index, (B, 1, K) rows as a strided view, and the
    shapes the kernel refuses."""
    from padt_tpu_torch.ops import matmul as MM

    g = torch.Generator(device=dev).manual_seed(5)
    w = _randn(g, (2, 128, 64), dev, scale=0.1)
    buf = _randn(g, (9, 1, 384), dev)
    x = buf[..., 128:256]
    out = MM.stream_matmul_stacked(x, w, torch.tensor(1, device=dev))
    torch.cuda.synchronize()
    assert out.shape == (9, 1, 64)
    assert torch.equal(out, MM.stream_matmul_stacked(x.contiguous(), w, 1))
    with pytest.raises(ValueError, match="bf16"):
        MM.stream_matmul_stacked(x.float(), w, 0)
    with pytest.raises(ValueError, match="out of range"):
        MM.stream_matmul_stacked(x, w, 2)
    with pytest.raises(ValueError, match="multiples of 8"):
        MM.stream_matmul_stacked(x[..., :60], w[:, :60], 0)


def test_stream_matmul_refuses_inputs_that_require_grad(dev):
    """H10 has no backward: with grad mode on it raises on x, w, ln_w or bias
    that require grad (the raw-pointer output would cut the graph); under
    no_grad it runs."""
    from padt_tpu_torch.ops import matmul as MM

    g = torch.Generator(device=dev).manual_seed(6)
    x, w = _randn(g, (4, 128), dev), _randn(g, (2, 128, 64), dev, scale=0.1)
    ln, b = torch.ones((2, 128), dtype=torch.bfloat16, device=dev), torch.zeros((2, 64), dtype=torch.bfloat16, device=dev)
    for i in range(4):
        args = [x, w, ln, b]
        args[i] = args[i].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="cut the autograd graph"):
            MM.stream_matmul_stacked(args[0], args[1], 1, ln_w=args[2], bias=args[3])
        with torch.no_grad():
            out = MM.stream_matmul_stacked(args[0], args[1], 1, ln_w=args[2], bias=args[3])
        torch.cuda.synchronize()
        assert torch.equal(out, MM.stream_matmul_stacked(x, w, 1, ln_w=ln, bias=b))


# ---------------------------------------------------------------------------
# Training: H2's LSE output, H1 with the sin negated, H8 flash_bwd_dq and H9
# flash_bwd_dkv vs their twins; the wrappers refuse inputs that require grad
# ---------------------------------------------------------------------------


def _train_inputs(g, dev, b, s, h, hkv, hd, pad):
    q, gr = _randn(g, (b, s, h, hd), dev), _randn(g, (b, s, h, hd), dev)
    k, v = _randn(g, (b, s, hkv, hd), dev), _randn(g, (b, s, hkv, hd), dev)
    seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
    seg[0, :pad] = -1  # left padding
    if b > 2:
        seg[2] = -1  # a row that sees no key at all
    return q, k, v, gr, seg


@pytest.mark.parametrize("b,s,h,hkv,hd", [(3, 203, 4, 2, 128), (2, 640, 16, 2, 128), (2, 130, 28, 4, 128), (2, 77, 4, 4, 80), (2, 100, 4, 1, 64)])
def test_segment_flash_lse_matches_plain(dev, b, s, h, hkv, hd):
    from padt_tpu_torch.ops import cuda_attention as CA

    g = torch.Generator(device=dev).manual_seed(s)
    q, k, v, _, seg = _train_inputs(g, dev, b, s, h, hkv, hd, 37)
    out, lse = CA.segment_flash_fwd(q, k, v, seg, seg, True, hd**-0.5, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = CA.segment_flash_plain(q, k, v, seg, seg, True, hd**-0.5, return_lse=True)
    assert _err(out, ref) < TOL
    empty = ref_lse >= 1e29
    assert torch.equal(lse >= 1e29, empty)
    assert (lse - ref_lse)[~empty].abs().max().item() < 1e-3  # fp32 log-sum-exp of bf16 scores
    assert torch.equal(out, CA.segment_flash_fwd(q, k, v, seg, seg, True, hd**-0.5))  # the LSE changes nothing else


# H8/H9 against their twins: 2e-2 of the largest reference output, since the
# kernels round ds and p to bf16 at other places than the fp32 twins and sum
# in fp32 in another order. A gradient that is 0 in exact arithmetic (one
# visible key per row, so dp - delta cancels: dq and dk at length 1) is
# fp32 cancellation noise on both sides, held to BWD_ZERO absolute instead.
# Each output is also held as a whole, to a relative norm gap of BWD_NORM,
# so that errors in its small entries (late keys, rows of few keys) count.
BWD_TOL = 2e-2
BWD_ZERO = 1e-6
BWD_NORM = 1e-2


def _bwd_check(args, seg_q, seg_k, causal):
    """H8 and H9 on `args` against the twins (one launch each), with exact
    zeros where a row or key has no visible partner; then again, bit for bit
    (no atomics: the cluster fold sums in one fixed order)."""
    from padt_tpu_torch.ops import cuda_flash_bwd as FB

    n0 = dict(FB.launch_counts)
    dq = FB.flash_bwd_dq(*args)
    dk, dv = FB.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert FB.launch_counts == {k_: n0[k_] + 1 for k_ in n0}
    rq, (rk, rv) = FB.flash_bwd_dq_plain(*args), FB.flash_bwd_dkv_plain(*args)
    for got, ref in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.shape == ref.shape and got.dtype == torch.bfloat16
        top = ref.float().abs().max().item()
        assert _err(got, ref) <= (BWD_TOL * top if top > 100 * BWD_ZERO else BWD_ZERO)
        if top > 100 * BWD_ZERO:
            assert ((got.float() - ref.float()).norm() / ref.float().norm()).item() <= BWD_NORM
    vis = C.visible(seg_q, seg_k, causal)[:, 0]  # (B, Sq, Sk)
    lone_rows, lone_keys = ~vis.any(-1), ~vis.any(1)
    if lone_rows.any():
        assert float(dq[lone_rows].float().abs().max()) == 0.0
    if lone_keys.any():
        assert float(dk[lone_keys].float().abs().max()) == 0.0 and float(dv[lone_keys].float().abs().max()) == 0.0
    dq2 = FB.flash_bwd_dq(*args)
    dk2, dv2 = FB.flash_bwd_dkv(*args)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    return dq, dk, dv


@pytest.mark.parametrize("b,s,h,hkv,hd,causal", [
    (3, 203, 4, 2, 128, True), (2, 640, 16, 2, 128, True), (2, 130, 28, 4, 128, True),
    (2, 96, 4, 4, 80, False), (2, 100, 4, 1, 64, True),
    (2, 704, 16, 2, 128, False), (2, 77, 2, 1, 80, True), (3, 1, 4, 4, 64, False), (2, 1, 4, 2, 128, True),
    (2, 333, 8, 2, 32, True), (2, 129, 8, 1, 32, False), (2, 129, 7, 1, 16, False), (2, 333, 14, 2, 16, True),
    (2, 200, 16, 1, 64, True), (2, 150, 24, 2, 80, False),
])
def test_flash_bwd_matches_plain(dev, b, s, h, hkv, hd, causal):
    """dq, dk, dv against the twins from the same LSE and delta: every head
    dim, causal and not; GQA 1:1, 2:1, 4:1, 7:1, 8:1 and past the cluster of
    8 (16:1, and 12:1, whose CTAs fold two heads or one); lengths 1, 77,
    129, 333 and 704 (tails past a 64- and a 128-row tile); left padding, a
    row with no visible key, segments and right padding; twice, bit for
    bit."""
    from padt_tpu_torch.ops import cuda_attention as CA

    g = torch.Generator(device=dev).manual_seed(s + h)
    q, k, v, gr, seg = _train_inputs(g, dev, b, s, h, hkv, hd, 37)
    if not causal:
        seg = torch.sort(torch.randint(0, 3, (b, s), generator=g, device=dev), dim=1).values.int()
        if s > 11:
            seg[:, -11:] = -1
    scale = hd**-0.5
    out, lse = CA.segment_flash_fwd(q, k, v, seg, seg, causal, scale, return_lse=True)
    delta = (gr.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq, _, _ = _bwd_check((q, k, v, gr, seg, seg, lse, delta, causal, scale), seg, seg, causal)
    if (seg < 0).any():
        assert float(dq[seg < 0].float().abs().max()) == 0.0


@pytest.mark.parametrize("layout", ["seg_win", "seg_full"])
def test_flash_bwd_window_slots(dev, layout):
    """H8/H9 over the vision tower's layouts at hd 80 (the unfrozen tower's
    backward): q, k, v and dO as head views of fused buffers, non-causal;
    on seg_win most tiles are skipped."""
    from padt_tpu_torch.ops import cuda_attention as CA

    g = torch.Generator(device=dev).manual_seed(80)
    b, h, hd = 2, 4, 80
    geo = vision_geometry([(1, 46, 46), (1, 20, 28)], 2304)
    seg = torch.as_tensor(getattr(geo, layout), device=dev)
    s = seg.shape[1]
    qkv, gg = _randn(g, (b, s, 3 * h * hd), dev), _randn(g, (b, s, 2 * h * hd), dev)
    q, k, v = (qkv[..., i * h * hd : (i + 1) * h * hd].unflatten(-1, (h, hd)) for i in range(3))
    gr = gg[..., h * hd :].unflatten(-1, (h, hd))
    scale = hd**-0.5
    out, lse = CA.segment_flash_fwd(q, k, v, seg, seg, False, scale, return_lse=True)
    delta = (gr.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    _bwd_check((q, k, v, gr, seg, seg, lse, delta, False, scale), seg, seg, False)


def test_flash_bwd_beyond_the_summary_table(dev):
    """One batch row of 12288 tokens: 192 query tiles of 64 + 96 key tiles of
    128 (H9), 96 + 192 (H8), past the kernels' table of 256 summaries, so
    their producers summarise each tile as they go; causal, segments."""
    from padt_tpu_torch.ops import cuda_attention as CA

    g = torch.Generator(device=dev).manual_seed(12288)
    b, s, h, hkv, hd = 1, 12288, 2, 1, 64
    q, k, v, gr, _ = _train_inputs(g, dev, b, s, h, hkv, hd, 0)
    seg = torch.sort(torch.randint(0, 40, (b, s), generator=g, device=dev), dim=1).values.int()
    seg[:, :300] = -1
    scale = hd**-0.5
    out, lse = CA.segment_flash_fwd(q, k, v, seg, seg, True, scale, return_lse=True)
    delta = (gr.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    _bwd_check((q, k, v, gr, seg, seg, lse, delta, True, scale), seg, seg, True)


def test_rope_negated_sin_is_the_vjp(dev):
    """H1 with sin_sign -1 matches its twin, and undoes the rotation."""
    from padt_tpu_torch.ops import cuda_attention as CA
    from padt_tpu_torch.ops.rope import mrope_cos_sin

    g = torch.Generator(device=dev).manual_seed(11)
    b, s, hq, hk, hd = 2, 640, 16, 2, 128
    pos = torch.arange(s, device=dev)[None].expand(3, b, s)
    cos, sin = mrope_cos_sin(pos, hd, (16, 24, 24))
    q, k = _randn(g, (b, s, hq * hd), dev), _randn(g, (b, s, hk * hd), dev)
    dq, dk = CA.rope_qk(q, k, cos, sin, hq, hk, sin_sign=-1.0)
    torch.cuda.synchronize()
    pq, pk = CA.rope_qk_plain(q, k, cos, sin, hq, hk, sin_sign=-1.0)
    assert _err(dq, pq) < TOL and _err(dk, pk) < TOL
    qr, _ = CA.rope_qk(q, None, cos, sin, hq, 0)
    back, _ = CA.rope_qk(qr, None, cos, sin, hq, 0, sin_sign=-1.0)
    assert _err(back, q) < 3 * TOL  # two bf16 roundings


def test_autograd_functions_run_the_kernels(dev):
    """causal_attention and rope_pair_packed under autograd on the card:
    gradients through H2+LSE, H8/H9 and H1 forward and VJP, close to the
    twins' gradients on the same inputs moved to the CPU in float32."""
    from padt_tpu_torch.ops import attention as A
    from padt_tpu_torch.ops import cuda_attention as CA
    from padt_tpu_torch.ops import cuda_flash_bwd as FB
    from padt_tpu_torch.ops.rope import mrope_cos_sin

    g = torch.Generator(device=dev).manual_seed(5)
    b, s, h, hkv, hd = 2, 256, 8, 2, 128
    pos = torch.arange(s, device=dev)[None].expand(3, b, s)
    cos, sin = mrope_cos_sin(pos, hd, (16, 24, 24))
    qp, kp = _randn(g, (b, s, h * hd), dev), _randn(g, (b, s, hkv * hd), dev)
    v, w = _randn(g, (b, s, hkv, hd), dev), _randn(g, (b, s, h, hd), dev)
    valid = torch.ones((b, s), dtype=torch.bool, device=dev)
    valid[0, :50] = False

    def run(qp, kp, v, cos, sin, valid, w):
        qp, kp, v = (t.detach().requires_grad_() for t in (qp, kp, v))
        q, k = A.rope_pair_packed(qp, kp, cos, sin, h, hkv)
        out = A.causal_attention(q.unflatten(-1, (h, hd)), k.unflatten(-1, (hkv, hd)), v, valid)
        (out.float() * w.float() * valid[:, :, None, None]).sum().backward()
        return [t.grad.float().cpu() for t in (qp, kp, v)]

    n_rope, n_fwd, n_bwd = CA.launch_counts["rope_qk"], CA.launch_counts["segment_flash_fwd"], dict(FB.launch_counts)
    got = run(qp, kp, v, cos, sin, valid, w)
    torch.cuda.synchronize()
    assert CA.launch_counts["rope_qk"] == n_rope + 2 and CA.launch_counts["segment_flash_fwd"] == n_fwd + 1
    assert all(FB.launch_counts[k_] == n_bwd[k_] + 1 for k_ in n_bwd)
    cpu = lambda t: t.float().cpu()
    ref = run(*(cpu(t) for t in (qp, kp, v, cos, sin)), valid.cpu(), cpu(w))
    for a, r in zip(got, ref):
        assert (a - r).abs().max().item() <= 3e-2 * r.abs().max().item()


def test_wrappers_refuse_inputs_that_require_grad(dev):
    """Outside their autograd Functions the kernel wrappers raise on CUDA
    inputs that require grad (the raw-pointer output would cut the graph);
    under no_grad they run."""
    from padt_tpu_torch.ops import cuda_attention as CA

    g = torch.Generator(device=dev).manual_seed(2)
    q = _randn(g, (1, 64, 2, 64), dev).requires_grad_()
    seg = torch.zeros((1, 64), dtype=torch.int32, device=dev)
    cos = torch.ones((1, 64, 64), device=dev)
    with pytest.raises(RuntimeError, match="cut the autograd graph"):
        CA.segment_flash_fwd(q, q.detach(), q.detach(), seg, seg, True, 0.125)
    with pytest.raises(RuntimeError, match="cut the autograd graph"):
        CA.window_slot_attn(q, q.detach(), q.detach(), seg, 0.125)
    with pytest.raises(RuntimeError, match="cut the autograd graph"):
        CA.rope_qk(q.flatten(2), None, cos, cos * 0, 2, 0)
    with torch.no_grad():
        CA.segment_flash_fwd(q, q, q, seg, seg, True, 0.125)
        CA.rope_qk(q.flatten(2), None, cos, cos * 0, 2, 0)
    torch.cuda.synchronize()
