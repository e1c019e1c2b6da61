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


def _bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers (8 significant bits) at magnitude x > 0."""
    return 2.0 ** (math.floor(math.log2(max(x, 2.0**-126))) - 7)


def _within_one_ulp(out, ref):
    """Every element within one bf16 ulp of the largest reference output:
    the kernel rounds once, as its twin does, from a product summed in
    another order."""
    return _err(out, ref) <= _bf16_ulp(ref.float().abs().max().item())


# (batch, seq): rows 1, 3 and 8 (decode), 16, 154 and 600 (this test's earlier cases), and 4608 (the
# vision tower's 2x2304)
ROPE_ROWS = [(1, 1), (3, 1), (8, 1), (2, 8), (2, 77), (2, 300), (2, 2304)]


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("b,s", ROPE_ROWS)
def test_rope_qk_matches_plain(dev, b, s, hd):
    """H1 at every head dim and row count against its twin, within one bf16
    ulp of the largest output: q/k as column views of a fused qkv buffer
    and as tensors of their own, q alone (k None), and the VJP (sin
    negated); the launch count moves once per call, under its shape."""
    g = torch.Generator(device=dev).manual_seed(hd + s)
    hq, hk = (16, 16) if s > 1000 else (4, 2)
    cos, sin = _tables(b, s, hd, dev, g)
    qkv = _randn(g, (b, s, (hq + 2 * hk) * hd), dev)
    views = (qkv[..., : hq * hd], qkv[..., hq * hd : (hq + hk) * hd])
    own = (_randn(g, (b, s, hq * hd), dev), _randn(g, (b, s, hk * hd), dev))
    for q, k in (views, own):
        for sign in (1.0, -1.0):
            n0, m0 = C.launch_counts["rope_qk"], C.rope_launches_by_shape.get((b * s, hq, hk), 0)
            qr, kr = C.rope_qk(q, k, cos, sin, hq, hk, sin_sign=sign)
            torch.cuda.synchronize()
            assert C.launch_counts["rope_qk"] == n0 + 1 and C.rope_launches_by_shape[(b * s, hq, hk)] == m0 + 1
            pq, pk = C.rope_qk_plain(q, k, cos, sin, hq, hk, sin_sign=sign)
            assert _within_one_ulp(qr, pq) and _within_one_ulp(kr, pk)
            assert _err(qr, pq) < TOL and _err(kr, pk) < TOL
            qo, none = C.rope_qk(q, None, cos, sin, hq, 0, sin_sign=sign)
            assert none is None and _within_one_ulp(qo, pq)


@pytest.mark.parametrize("hpt,block", [(1, 16), (2, 64), (1, 256), (2, 128)])
def test_rope_qk_every_plan(dev, hpt, block):
    """Both instances of the kernel (1 and 2 heads per thread) at block
    sizes of 16-256 give the twin's output (18 = 16 + 2 heads)."""
    g = torch.Generator(device=dev).manual_seed(hpt)
    b, s, hq, hk, hd = 2, 77, 16, 2, 128
    cos, sin = _tables(b, s, hd, dev, g)
    q, k = _randn(g, (b, s, hq * hd), dev), _randn(g, (b, s, hk * hd), dev)
    plan = C.rope_plan(b * s, hq + hk, hd, hpt=hpt, block=block)
    qr, kr = C.rope_qk(q, k, cos, sin, hq, hk, plan=plan)
    torch.cuda.synchronize()
    pq, pk = C.rope_qk_plain(q, k, cos, sin, hq, hk)
    assert _within_one_ulp(qr, pq) and _within_one_ulp(kr, pk)


def test_rope_qk_refuses_unaligned_rows(dev):
    """16-byte lanes: a view that starts off a 16-byte boundary, or whose
    rows are not 16 bytes apart, raises; nothing falls back."""
    g = torch.Generator(device=dev).manual_seed(3)
    b, s, h, hd = 2, 8, 2, 64
    cos, sin = _tables(b, s, hd, dev, g)
    buf = _randn(g, (b, s, 2 * h * hd + 8), dev)
    with pytest.raises(ValueError, match="16-byte"):
        C.rope_qk(buf[..., 1 : 1 + h * hd], None, cos, sin, h, 0)  # starts 2 bytes in
    odd = _randn(g, (b, s, h * hd + 4), dev)
    with pytest.raises(ValueError, match="16-byte"):
        C.rope_qk(odd[..., : h * hd], None, cos, sin, h, 0)  # rows 8 bytes off the grid
    with pytest.raises(ValueError, match="multiple of 16"):
        c8, s8 = _tables(b, s, 8, dev, g)
        C.rope_qk(buf[..., :16], None, c8, s8, 2, 0)


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


WINDOW_GRIDS = [(1, 20, 28), (1, 14, 14), (1, 8, 8), (1, 28, 20), (1, 12, 16), (1, 16, 12), (1, 10, 10), (1, 22, 18)]


def _norm_gap(out, ref):
    return ((out.float() - ref.float()).norm() / ref.float().norm()).item()


@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
def test_window_slot_matches_plain(dev, hd):
    """H3 at B = 8 and every head dim, q/k/v strided views of one fused qkv
    buffer, against its twin: within 2e-2 of the largest output and a 1e-2
    relative norm gap; a slot with no valid key gives exactly 0; two runs
    are bit-identical."""
    g = torch.Generator(device=dev).manual_seed(hd)
    h = 4
    geo = vision_geometry(WINDOW_GRIDS, 768)
    assert geo.pack_index is not None
    seg = torch.as_tensor(geo.seg_win, device=dev).clone()
    b, s = seg.shape
    assert b == 8
    seg[3, 64:128] = -1  # a slot with no valid key
    qkv = _randn(g, (b, s, 3 * h * hd), dev)
    q, k, v = (qkv[..., i * h * hd : (i + 1) * h * hd].unflatten(-1, (h, hd)) for i in range(3))
    out = C.window_slot_attn(q, k, v, seg, hd**-0.5)
    torch.cuda.synchronize()
    ref = C.window_slot_plain(q, k, v, seg, hd**-0.5)
    assert _err(out, ref) < TOL and _err(out, ref) <= TOL * ref.float().abs().max().item()
    assert _norm_gap(out, ref) <= 1e-2
    assert float(out[3, 64:128].float().abs().max()) == 0.0 and float(ref[3, 64:128].float().abs().max()) == 0.0
    again = C.window_slot_attn(q, k, v, seg, hd**-0.5)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.parametrize("ctas", [1, 7, 132, 500])
def test_window_slot_every_grid(dev, ctas):
    """Any number of persistent CTAs walks every item once: fewer CTAs than
    items (each CTA's two warpgroups take many items), and more than items."""
    g = torch.Generator(device=dev).manual_seed(ctas)
    b, s, h, hd = 2, 448, 3, 80
    q, k, v = (_randn(g, (b, s, h, hd), dev) for _ in range(3))
    seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
    seg[0, 100:140] = -1
    seg[1, 384:] = -1  # the last slot of row 1: no valid key
    out = C.window_slot_attn(q, k, v, seg, hd**-0.5, plan=C.window_plan(b, s, h, hd, ctas=ctas))
    torch.cuda.synchronize()
    ref = C.window_slot_plain(q, k, v, seg, hd**-0.5)
    assert _err(out, ref) < TOL and _err(out, ref) <= TOL * ref.float().abs().max().item()
    assert _norm_gap(out, ref) <= 1e-2
    assert float(out[1, 384:].float().abs().max()) == 0.0


def test_window_slot_plans_agree_bit_for_bit(dev):
    """At the train step's tower shape (8x2304, 16 heads of 80, v a view of
    the fused qkv) every launch plan, run many times in a row, gives the
    default plan's output bit for bit: an item's arithmetic does not depend
    on which CTA, warpgroup or ring stage takes it. A ring of an odd count
    of stages is refused (its warpgroups would alternate on a stage)."""
    g = torch.Generator(device=dev).manual_seed(8)
    b, s, h, hd = 8, 2304, 16, 80
    seg = torch.as_tensor(vision_geometry([(1, 46, 46)] * b, s).seg_win, device=dev)
    qkv = _randn(g, (b, s, 3 * h * hd), dev)
    q, k = _randn(g, (b, s, h, hd), dev), _randn(g, (b, s, h, hd), dev)
    v = qkv[..., 2 * h * hd :].unflatten(-1, (h, hd))
    ref = C.window_slot_attn(q, k, v, seg, hd**-0.5)
    torch.cuda.synchronize()
    assert _err(ref, C.window_slot_plain(q, k, v, seg, hd**-0.5)) <= TOL * 0.1
    for ctas, stages in [(110, 2), (110, 4), (100, 6), (66, 4), (132, 2), (132, 6), (97, 4)]:
        plan = C.window_plan(b, s, h, hd, ctas=ctas, stages=stages)
        outs = [C.window_slot_attn(q, k, v, seg, hd**-0.5, plan=plan) for _ in range(20)]
        torch.cuda.synchronize()
        assert all(torch.equal(o, ref) for o in outs), (ctas, stages)
    with pytest.raises(ValueError, match="even"):
        C.window_slot_attn(q, k, v, seg, hd**-0.5, plan=C.window_plan(b, s, h, hd, ctas=110, stages=3))


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


def _norm_gap(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30)).item()


def _decode_case(dev, seed, b, c, hd, g, form):
    """Inputs of one H4 call in `form`: "fresh" (K6), "cache" (K13 / K14),
    "n_valid" (K15) or "qi8" (K6 with quantize_q)."""
    from padt_tpu_torch.ops import cuda_kv as K

    gen = torch.Generator(device=dev).manual_seed(seed)
    k8, ks, v8, vs, kn, ksn, vn, vsn = _int8_cache(gen, dev, 2, b, 2, c, hd, 1)
    q = _randn(gen, (b, 2, g, hd), dev)
    valid, nv = _valid_patterns(b, c, dev), None
    fresh = (kn, ksn, vn, vsn) if form in ("fresh", "qi8") else (None,) * 4
    if form == "n_valid":
        nv, valid = _live_cache(gen, dev, b, c)
    args = (q, k8, ks, v8, vs, *fresh, valid, 1)
    kw = dict(n_valid=nv, quantize_q=form == "qi8")
    return K.int8_decode_attn, K.int8_decode_attn_plain, args, kw


def _verify_case(dev, seed, b, c, hd, kq, fresh):
    """Inputs of one H5 call with kq fresh columns (K8) or the causal limit
    (K16)."""
    from padt_tpu_torch.ops import cuda_kv as K

    gen = torch.Generator(device=dev).manual_seed(seed)
    k8, ks, v8, vs, kn, ksn, vn, vsn = _int8_cache(gen, dev, 2, b, 2, c, hd, kq)
    q = _randn(gen, (b, 2, 8 * kq, hd), dev)
    valid, wp = _valid_patterns(b, c, dev), None
    if not fresh:
        wp = torch.tensor([max(c // 2, 0), 30, c - kq, 1, 0][:b] + [0] * max(b - 5, 0), dtype=torch.int32, device=dev).clamp(0, max(c - kq, 0))
        cols = torch.arange(c, device=dev)[None, :]
        valid = valid | ((cols >= wp[:, None]) & (cols < wp[:, None] + kq))
    f = (kn, ksn, vn, vsn) if fresh else (None,) * 4
    return K.int8_verify_attn, K.int8_verify_attn_plain, (q, k8, ks, v8, vs, *f, valid, 1, kq), dict(write_pos=wp)


_DECODE_FORMS = ["fresh", "cache", "n_valid", "qi8"]


@pytest.mark.parametrize("form", _DECODE_FORMS)
@pytest.mark.parametrize("c", [127, 128, 129])
def test_int8_decode_tile_edges_and_reruns(dev, form, c):
    """H4 at capacities on both sides of a 64-column tile edge, in every
    form: within TOL of its twin and a relative norm gap of 1e-2 (K15's twin
    rounds in its own order: 2e-2 of the largest output), and two runs give
    the same bits (no atomics)."""
    kern, plain, args, kw = _decode_case(dev, c, 5, c, 128, 8, form)
    out, again = kern(*args, **kw), kern(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref = plain(*args, **kw)
    tol = TOL * ref.float().abs().max().item() if form == "n_valid" else TOL
    assert _err(out, ref) < tol and _norm_gap(out, ref) <= 1e-2


@pytest.mark.parametrize("form", _DECODE_FORMS)
def test_int8_decode_seven_query_heads(dev, form):
    """G = 7 (PaDT-7B's 28 / 4 heads): the mma's eighth row is padding."""
    kern, plain, args, kw = _decode_case(dev, 7, 8, 768, 128, 7, form)
    out = kern(*args, **kw)
    torch.cuda.synchronize()
    ref = plain(*args, **kw)
    tol = TOL * ref.float().abs().max().item() if form == "n_valid" else TOL
    assert out.shape == ref.shape and _err(out, ref) < tol and _norm_gap(out, ref) <= 1e-2


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("kq,c", [(5, 197), (4, 127), (4, 128), (4, 129), (32, 768)])
@pytest.mark.parametrize("fresh", [True, False])
def test_int8_verify_head_dims_tile_edges_and_reruns(dev, hd, kq, c, fresh):
    """H5 at hd 64 / 128 / 256, kq = 5 (rows that straddle a query head),
    capacities on both sides of a tile edge, with fresh columns (K8) and
    with the causal limit (K16): within TOL and a norm gap of 1e-2 of its
    twin, two runs bit for bit."""
    kern, plain, args, kw = _verify_case(dev, hd + kq + c, 5, c, hd, kq, fresh)
    out, again = kern(*args, **kw), kern(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref = plain(*args, **kw)
    assert _err(out, ref) < TOL and _norm_gap(out, ref) <= 1e-2


@pytest.mark.parametrize("c,kq", [(197, 4), (768, 32)])
def test_int8_verify_causal_limit_without_a_visible_key(dev, c, kq):
    """K16 when a slot's first query row sees no valid column at or before
    write_pos (slot 1: nothing valid; slot 2: only columns past
    write_pos + kq): the kernel then reads the whole cache instead of
    stopping at write_pos + kq, so a row with no visible key gets the V
    rows' mean as the twin's uniform softmax does."""
    from padt_tpu_torch.ops import cuda_kv as K

    gen = torch.Generator(device=dev).manual_seed(c + kq)
    k8, ks, v8, vs = _int8_cache(gen, dev, 2, 3, 2, c, 128, 1)[:4]
    q = _randn(gen, (3, 2, 8 * kq, 128), dev)
    wp = torch.tensor([c // 2, 10, 20], dtype=torch.int32, device=dev)
    cols = torch.arange(c, device=dev)[None, :]
    valid = (cols >= wp[:, None]) & (cols < wp[:, None] + kq)
    valid[1] = False
    valid[2] = cols[0] >= 20 + kq + 5
    out = K.int8_verify_attn(q, k8, ks, v8, vs, None, None, None, None, valid, 1, kq, write_pos=wp)
    torch.cuda.synchronize()
    ref = K.int8_verify_attn_plain(q, k8, ks, v8, vs, None, None, None, None, valid, 1, kq, write_pos=wp)
    assert _err(out, ref) < TOL and _norm_gap(out, ref) <= 1e-2
    mean = (v8[1, 1].float() * vs[1, 1][..., None]).mean(dim=1)  # slot 1: every row uniform
    assert _err(out[1], mean[:, None].expand(2, 8 * kq, 128)) < TOL


@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_int8_attention_past_the_old_shared_memory_limit(dev, kind):
    """A capacity the kernels before the two-sweep design refused (their
    score row outgrew a block's shared memory): H4 at C = 60000 (8 CTAs a
    cluster), H5 at C = 20000 with a suffix pass's 256 rows."""
    from padt_tpu_torch.ops import cuda_kv as K

    if kind == "decode":
        kern, plain, args, kw = _decode_case(dev, 1, 3, 60000, 128, 8, "fresh")
        plan = K.attn_plan("decode", 3, 2, 8, 60000, 128, 1)
    else:
        kern, plain, args, kw = _verify_case(dev, 2, 3, 20000, 128, 32, True)
        plan = K.attn_plan("verify", 3, 2, 256, 20000, 128, 32)
    assert plan.smem <= K._SMEM_LIMIT
    out = kern(*args, **kw)
    torch.cuda.synchronize()
    ref = plain(*args, **kw)
    assert _err(out, ref) < TOL and _norm_gap(out, ref) <= 1e-2


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


GEMM_NORM = 1e-2  # H7 / H10: ||kernel - twin|| / ||twin|| (bf16 output rounding, another order of sums)


def _gemm_check(out, ref):
    """2e-2 of the largest output, and a relative norm gap of 1e-2 over the
    whole output (as `_bwd_check`): a wrong split or tile that leaves small
    outputs wrong fails the second."""
    assert _err(out, ref) <= 2e-2 * ref.float().abs().max().item()
    assert ((out.float() - ref.float()).norm() / ref.float().norm()).item() <= GEMM_NORM


# the launch plans of these shapes are checked on the CPU (tests/test_torch_gemm_plan.py, CARD_H7 / CARD_H10)
@pytest.mark.parametrize(
    "m,k,n",
    [(1, 96, 64), (7, 96, 96), (65, 160, 96), (130, 128, 320), (8, 3584, 3584), (256, 3584, 4608), (300, 200, 48),
     (128, 512, 320), (129, 512, 320), (8, 4096, 1024), (8, 512, 1024), (8, 256, 1024), (8, 64, 1024),
     (8, 1000, 1008), (4, 3584, 4608)],
)
def test_int8_matmul_matches_plain(dev, m, k, n):
    """M, N and K tails (the tiny model's N of 64..320 and K of 96 / 160,
    K = 200 and 1000 not a multiple of the 64-row stage, N = 1008 not a
    multiple of the 128-column tile), both orientations at the switch
    (swap-AB at M = 128, the usual one at 129), clusters of 8, 4, 2 and 1 K
    splits (M = 8, N = 1024, K = 4096 / 512 / 256 / 64), 7B's widths at M =
    4, 8 and 256. Tolerance: `_gemm_check`."""
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
    _gemm_check(out, ref)


@pytest.mark.parametrize("m,k,n", [(8, 4096, 1024), (96, 11008, 2048)])
def test_split_k_reruns_are_bit_identical(dev, m, k, n):
    """H7 and H10 at split-K shapes (clusters of 8, and 8 / 5): the K splits are
    folded in rank order, with no atomics, so two calls give the same bits."""
    from padt_tpu_torch.ops import cuda_matmul as CM
    from padt_tpu_torch.ops import matmul as MM
    from padt_tpu_torch.ops import quant

    assert CM.launch_plan(m, n, k).splits > 1
    g = torch.Generator(device=dev).manual_seed(11)
    x = _randn(g, (m, k), dev)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = torch.full((n,), 1e-3, device=dev)
    w = _randn(g, (2, k, n), dev, scale=k**-0.5)
    ln = (1.0 + torch.randn((2, k), generator=g, device=dev) * 0.1).to(torch.bfloat16)
    a = [quant.int8_matmul(x, wq, s), MM.stream_matmul_stacked(x, w, 1, ln_w=ln), MM.stream_matmul_stacked(x, w, 0)]
    b = [quant.int8_matmul(x, wq, s), MM.stream_matmul_stacked(x, w, 1, ln_w=ln), MM.stream_matmul_stacked(x, w, 0)]
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)


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
     (96, 11008, 2048, False, False), (5, 96, 256, True, True), (130, 160, 96, True, False), (300, 200, 48, False, True),
     (128, 512, 320, True, True), (129, 512, 320, True, True), (8, 4096, 1024, False, True), (8, 512, 1024, True, False),
     (8, 256, 1024, False, False), (8, 64, 1024, True, True), (96, 1000, 1000, True, True)],
)
def test_stream_matmul_matches_plain(dev, m, k, n, fuse, bias):
    """The four PaDT-3B decode products at M = 96 (K splits 4, 5, 1 and 5),
    the tiny model's widths, M past one 128-row tile, K = 200 and 1000 not a
    multiple of the 64-row stage, N = 1000 not a multiple of the tile, both
    orientations at the switch (M = 128 and 129), clusters of 8, 4, 2 and 1
    K splits (M = 8, N = 1024, K = 4096 / 512 / 256 / 64). Tolerance:
    `_gemm_check`."""
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
    _gemm_check(out, ref)


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


# ---------------------------------------------------------------------------
# H6 store_kv_rows at the main path's shapes; the trained vision tower (H1
# + H2 with its LSE, H8 + H9 over its segment and slot ids) and PaDTTrainer
# with its default arguments
# ---------------------------------------------------------------------------


# (layers, slots, kv heads, rows per slot, hd): 3B decode, speculative verify and suffix pass over the 16-slot
# pool of chip_smoke's lines, PaDT-7B's decode, [forms]' one-layer views
STORE_SHAPES = [(36, 16, 2, 1, 128), (36, 16, 2, 4, 128), (36, 16, 2, 32, 128), (28, 8, 4, 1, 128), (1, 16, 2, 1, 128),
                (1, 16, 2, 32, 128)]


@pytest.mark.parametrize("shape", STORE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_store_kv_rows_main_path_shapes(dev, shape):
    """Byte-identical to the twin; n_rows 0, partial and kq, positions at 0,
    C - kq, C - 1 (rows past C dropped) and below 0; every instance (rows a
    thread) and block of the plan, with and without programmatic dependent
    launch, gives the same bytes."""
    from padt_tpu_torch.ops import cuda_kv as K

    nl, b, hkv, kq, hd = shape
    c = 200
    g = torch.Generator(device=dev).manual_seed(nl + kq)
    cache = _int8_cache(g, dev, nl, b, hkv, c, hd, 1)[:4]
    new = _int8_cache(g, dev, nl, b, hkv, kq, hd, 1)[:4]
    edge = [0, c - kq, c - 1, -1, 77]
    pos = torch.tensor([edge[i % len(edge)] for i in range(b)], dtype=torch.int32, device=dev)
    n_rows = torch.tensor([(kq, 0, max(kq // 2, 1))[i % 3] for i in range(b)], dtype=torch.int32, device=dev)
    ref = [t.clone() for t in cache]
    K.store_kv_rows_plain(*ref, *new, pos, n_rows)
    plans = [None] + [K.store_plan(nl, b, hkv, kq, hd, rpt=rpt, block=blk, pdl=pdl)
                      for rpt in K.STORE_RPTS for blk in K.STORE_BLOCKS for pdl in (False, True)]
    for plan in plans:
        got = [t.clone() for t in cache]
        n0 = K.launch_counts["store_kv_rows"]
        K.store_kv_rows(*got, *new, pos, n_rows, plan=plan)
        torch.cuda.synchronize()
        assert K.launch_counts["store_kv_rows"] == n0 + 1
        for a, r, name in zip(got, ref, ("k8", "ks", "v8", "vs")):
            assert torch.equal(a, r), (name, plan)


def test_store_kv_rows_refuses_rows_it_cannot_read(dev):
    """New rows that are not contiguous, of another dtype, on another
    device, or that do not start 16-byte aligned are refused, whichever of
    the four tensors it is."""
    from padt_tpu_torch.ops import cuda_kv as K

    g = torch.Generator(device=dev).manual_seed(3)
    k8, ks, v8, vs = _int8_cache(g, dev, 2, 2, 2, 64, 128, 1)[:4]
    new = _int8_cache(g, dev, 2, 2, 2, 4, 128, 1)[:4]
    pos = torch.zeros(2, dtype=torch.int32, device=dev)
    n = torch.full((2,), 4, dtype=torch.int32, device=dev)
    strided = lambda t: t.transpose(2, 3).contiguous().transpose(2, 3)
    shifted = lambda t: torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(t.shape)
    for i in range(4):
        for bad, what in ((strided, "contiguous"), (lambda t: t.cpu(), "device"), (shifted, "aligned"),
                          (lambda t: t.to(torch.bfloat16 if t.dtype == torch.float32 else torch.int16), "must be")):
            if what == "aligned" and i % 2:  # the scales move one word at a time: any 4-byte address will do
                continue
            rows = list(new)
            rows[i] = bad(rows[i])
            with pytest.raises(ValueError, match=what):
                K.store_kv_rows(k8, ks, v8, vs, *rows, pos, n)


@pytest.mark.parametrize("windowed", [False, True])
def test_vision_attention_trains_through_the_kernels(dev, windowed):
    """The vision calls under grad on the card: H1 + H2 with its LSE
    forward, H8 + H9 and H1 with the sin negated backward, over the slot
    ids on the window layout (no H3); d(qkv) close to the twins' on the same
    inputs moved to the CPU in float32 (pad rows: zero cotangent). The
    wrappers themselves still raise on inputs that require grad."""
    from padt_tpu_torch.ops import attention as A
    from padt_tpu_torch.ops import cuda_flash_bwd as FB

    g = torch.Generator(device=dev).manual_seed(11)
    grids = [(1, 16, 20), (1, 12, 12)]
    geo = vision_geometry(grids, 768)
    assert geo.pack_index is not None
    seg = torch.as_tensor(geo.seg_win if windowed else geo.seg_full, device=dev)
    b, s, h, hd = 2, 768, 16, 80
    cos, sin = _tables(b, s, hd, dev, g)
    qkv = _randn(g, (b, s, 3 * h * hd), dev)
    w = _randn(g, (b, s, h * hd), dev) * (seg >= 0)[:, :, None]
    fn = A.window_attention_qkv if windowed else A.fused_vision_attention_qkv

    def run(qkv, cos, sin, seg, w):
        x = qkv.detach().requires_grad_()
        (fn(x, cos, sin, seg, h, scale=hd**-0.5, rope_dim=hd).float() * w.float()).sum().backward()
        return x.grad.float().cpu()

    n0 = {k: C.launch_counts[k] for k in C.launch_counts}
    b0 = dict(FB.launch_counts)
    got = run(qkv, cos, sin, seg, w)
    torch.cuda.synchronize()
    assert {k: C.launch_counts[k] - n0[k] for k in n0} == {"rope_qk": 2, "segment_flash_fwd": 1, "window_slot_attn": 0}
    assert all(FB.launch_counts[k] == b0[k] + 1 for k in b0)
    cpu = lambda t: t.float().cpu()
    ref = run(cpu(qkv), cpu(cos), cpu(sin), seg.cpu(), cpu(w))
    assert (got - ref).abs().max().item() <= 3e-2 * ref.abs().max().item()
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-2
    with pytest.raises(RuntimeError, match="cut the autograd graph"):
        C.rope_qk(qkv[..., : h * hd].clone().requires_grad_(), None, cos, sin, h, 0)


def test_trainer_with_default_args_trains_the_tower(dev, tmp_path):
    """PaDTTrainer with TrainArgs' defaults (the tower trained, AdamW) on
    the tiny model takes two steps on the card: finite losses, every tower
    block leaf moved (or, a bf16 norm weight of 1.0, was reached by a
    gradient smaller than a bf16 step of 1.0, as chip_smoke's [train-tower]
    allows)."""
    import numpy as np

    from padt_tpu_torch import padt_tiny
    from padt_tpu_torch.models import padt as P
    from padt_tpu_torch.tools.profile_train import synthetic_rec
    from padt_tpu_torch.train.train_step import flat_leaves
    from padt_tpu_torch.train.trainer import PaDTTrainer, TrainArgs
    from padt_tpu_torch.utils.mock_tokenizer import make_tiny_tokenizer
    from padt_tpu_torch.vrt.processor import VisionTextProcessor

    cfg = padt_tiny()
    proc = VisionTextProcessor(make_tiny_tokenizer(cfg), cfg, seq_bucket=32, patch_bucket=cfg.max_image_patches)
    proc.prepare(cfg.text.vocab_size)
    rows, images = synthetic_rec(4, grid=(1, 16, 16), seed=5)
    params = P.init_padt_params(cfg, torch.Generator(device=dev).manual_seed(4), dev, torch.bfloat16)
    args = TrainArgs(output_dir=str(tmp_path), per_device_train_batch_size=2)
    assert not args.freeze_vision_modules and args.optimizer == "adamw"
    trainer = PaDTTrainer(cfg, params, proc, args, rows, images=images, device=dev)
    before = {n: t.detach().clone() for n, t in flat_leaves(trainer.params["vision"]["blocks"])}
    metrics = trainer.train()
    assert trainer.global_step == 2 and len(metrics) == 2
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in metrics)
    exp_avg = {n: trainer.optimizer.inner.state[t]["exp_avg"] for n, t in trainer.optimizer.leaves}
    unmoved = [n for n, t in flat_leaves(trainer.params["vision"]["blocks"]) if torch.equal(t, before[n])]
    unreached = [n for n in unmoved
                 if not (bool((before[n] == 1).all()) and float(exp_avg["vision.blocks." + n].abs().max()) > 0)]
    assert not unreached, f"tower block leaves that neither moved nor are bf16 ones reached by a gradient: {unreached}"
    assert len(unmoved) < len(before), "no tower block leaf moved"


# ---------------------------------------------------------------------------
# H12 swiglu and the packed vision tower (models/vision.py's serving layout)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,ff", [(4 * 2304, 3456), (333, 3456), (4 * 2304, 3424), (1, 8)])
def test_swiglu_matches_plain(dev, rows, ff):
    """H12 against its twin (fp32 SiLU and product, one rounding) at the
    packed tower's 4 x 2304 rows, a ragged row count and the least width:
    each value within one bf16 ulp of the twin's; two runs bit for bit."""
    from padt_tpu_torch.ops import cuda_mlp

    g = torch.Generator(device=dev).manual_seed(12)
    gu = _randn(g, (rows, 2 * ff), dev, scale=3.0)
    n0 = cuda_mlp.launch_counts["swiglu"]
    out, ref = cuda_mlp.swiglu(gu), cuda_mlp.swiglu_plain(gu)
    torch.cuda.synchronize()
    assert cuda_mlp.launch_counts["swiglu"] == n0 + 1 and out.shape == (rows, ff)
    ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp(min=2.0**-126))) - 7)
    assert bool(((out.float() - ref.float()).abs() <= ulp).all()), _err(out, ref)
    assert torch.equal(cuda_mlp.swiglu(gu), out)


def test_swiglu_refuses_what_the_kernel_does_not_take(dev):
    from padt_tpu_torch.ops import cuda_mlp

    gu = torch.zeros((4, 32), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        cuda_mlp.swiglu(gu.float())
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_mlp.swiglu(gu[:, :24])
    with pytest.raises(ValueError, match="contiguous"):
        cuda_mlp.swiglu(torch.zeros((4, 64), device=dev, dtype=torch.bfloat16)[:, :32])
    with pytest.raises(ValueError, match="grad"):
        cuda_mlp.swiglu(gu.clone().requires_grad_(True))


def test_packed_tower_runs_no_sm80_gemm(dev):
    """PaDT-3B's tower (32 blocks, ff 3420 packed to 3424) at 4 x 2304
    patches on the window-slot layout: under `torch.profiler` the packed
    forward runs no kernel whose name holds `cutlass_80` or `align2`, and
    H12 once a block; its outputs against the plain tower's within a
    relative norm gap of 5e-2 (bf16, the biases' roundings differ, over 32
    blocks)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from padt_tpu_torch import padt_3b
    from padt_tpu_torch.models import vision as V

    vc = padt_3b().vision
    g = torch.Generator(device=dev).manual_seed(3)
    params = V.init_vision_params(vc, g, dev, torch.bfloat16)
    for k in ("qkv_b", "proj_b", "gate_b", "up_b", "down_b"):
        params["blocks"][k] = (0.1 * torch.randn(params["blocks"][k].shape, generator=g, device=dev)).to(torch.bfloat16)
    packed = dict(params, blocks=V.pack_vision_blocks(params["blocks"]))
    grids = [(1, 48, 48)] * 4
    geo = vision_geometry(grids, 2304, window_slots=True)
    t = lambda a: torch.as_tensor(a, device=dev)
    pix = (torch.rand((4, 2304, vc.patch_input_dim), generator=g, device=dev) * 2 - 1).to(torch.bfloat16)
    args = [pix] + [t(a) for a in (geo.window_index, geo.inv_window_index, geo.seg_win, geo.seg_full, geo.hpos, geo.wpos)]
    run = lambda p: V.vision_forward(p, vc, *args, pack_index=t(geo.pack_index))
    with torch.no_grad():
        plain, ours = run(params), run(packed)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(packed)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and not [n for n in names if "cutlass_80" in n or "align2" in n], sorted(set(names))
    assert sum("swiglu_kernel" in n for n in names) == vc.depth
    for a, b in ((ours[0], plain[0]), (ours[1], plain[1])):
        gap = ((a.float() - b.float()).norm() / b.float().norm()).item()
        assert gap <= 5e-2, gap
