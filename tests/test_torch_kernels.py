"""The port's Hopper kernels vs their plain PyTorch twins, on the card.

These need an NVIDIA GPU with nvcc (the kernels are built from
padt_tpu_torch/csrc at first use) and skip elsewhere. Run them on the card
with `python -m pytest tests/test_torch_kernels.py -q`.

Tolerance 2e-2 absolute on bf16 outputs of magnitude ~1: the kernels round
to bf16 at other places than the fp32 twins (P before P.V, the output) and
sum in another order."""

import pytest
import torch

from padt_tpu.models.vision_geom import vision_geometry
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
