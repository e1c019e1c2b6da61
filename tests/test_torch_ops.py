"""PyTorch port ops vs the JAX package on the CPU, float32, tolerance 1e-5
(relative to the reference's magnitude): norms, both rope tables, and the
plain twins of the three Hopper kernels (H1 rope_qk, H2 segment_flash_fwd,
H3 window_slot_attn) against the JAX XLA branches and, once per kernel,
the Pallas kernel itself in interpret mode. Attention is compared on
valid rows only: a row with no valid key is 0 in the port (as in the TPU
kernels) and a uniform average in the XLA branches."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_common import close
from padt_tpu.ops import attention as JA
from padt_tpu.ops import norms as JN
from padt_tpu.ops import rope as JR
from padt_tpu.ops.pallas_attention import _unpack_rope_pad, flash_attention, rope_pair_packed
from padt_tpu_torch.ops import attention as TA
from padt_tpu_torch.ops import cuda_attention as TC
from padt_tpu_torch.ops import norms as TN
from padt_tpu_torch.ops import rope as TR

T = lambda a: torch.tensor(np.asarray(a))  # a writable copy


def _rng(seed):
    return np.random.RandomState(seed)


def _xla(fn, *args, **kw):
    """A padt_tpu.ops.attention entry point on its XLA branch."""
    os.environ["PADT_PALLAS"] = "0"
    try:
        return fn(*args, **kw)
    finally:
        os.environ.pop("PADT_PALLAS", None)


def _vision_tables(b, s, hd, seed=5):
    r = _rng(seed)
    hpos = np.sort(r.randint(0, 32, (b, s)), axis=1).astype(np.int32)
    wpos = np.sort(r.randint(0, 32, (b, s)), axis=1).astype(np.int32)
    jc, js = JR.vision_rope_cos_sin(jnp.asarray(hpos), jnp.asarray(wpos), hd)
    return np.asarray(jc), np.asarray(js), hpos, wpos


def _segments(b, s, seed, n_seg=4, pad=13):
    seg = np.sort(_rng(seed).randint(0, n_seg, (b, s)), axis=1).astype(np.int32)
    seg[:, s - pad :] = -1
    return seg


def _slot_segments(b, s, seed, win=64):
    r = _rng(seed)
    seg = np.full((b, s), -1, np.int32)
    for bi in range(b):
        for w in range(s // win):
            fill = r.randint(0, win + 1) // 4 * 4  # whole merge groups; 0 = an empty slot
            seg[bi, w * win : w * win + fill] = w
    return seg


def test_norms_match_jax():
    r = _rng(0)
    x = r.randn(2, 5, 48).astype(np.float32) * 3
    w, bias = r.randn(48).astype(np.float32), r.randn(48).astype(np.float32)
    close(TN.rms_norm(T(x), T(w)), JN.rms_norm(x, w))
    close(TN.layer_norm(T(x), T(w), T(bias), eps=1e-5), JN.layer_norm(x, w, bias, eps=1e-5))


def test_rope_tables_match_jax():
    jc, js, hpos, wpos = _vision_tables(2, 40, 80)
    tc, ts = TR.vision_rope_cos_sin(T(hpos), T(wpos), 80)
    close(tc, jc)
    close(ts, js)
    pos = np.cumsum(_rng(1).randint(0, 3, (3, 2, 24)), axis=-1).astype(np.int32)
    jc, js = JR.mrope_cos_sin(jnp.asarray(pos), 32, (4, 6, 6))
    tc, ts = TR.mrope_cos_sin(T(pos), 32, (4, 6, 6))
    close(tc, jc)
    close(ts, js)


def test_rope_qk_plain_matches_apply_rotary_on_text_shapes():
    b, l, h, hkv, hd = 2, 24, 4, 2, 32
    r = _rng(2)
    q = r.randn(b, l, h * hd).astype(np.float32)
    k = r.randn(b, l, hkv * hd).astype(np.float32)
    pos = np.cumsum(r.randint(0, 3, (3, b, l)), axis=-1).astype(np.int32)
    jc, js = JR.mrope_cos_sin(jnp.asarray(pos), hd, (4, 6, 6))
    cj, sj = jc[:, :, None, :], js[:, :, None, :]
    qr, kr = TC.rope_qk(T(q), T(k), T(np.asarray(jc)), T(np.asarray(js)), h, hkv)
    close(qr, np.asarray(JR.apply_rotary(q.reshape(b, l, h, hd), cj, sj)).reshape(b, l, -1))
    close(kr, np.asarray(JR.apply_rotary(k.reshape(b, l, hkv, hd), cj, sj)).reshape(b, l, -1))
    # q-only form (the decoder's rotary side)
    qo, none = TC.rope_qk(T(q), None, T(np.asarray(jc)), T(np.asarray(js)), h, 0)
    assert none is None
    close(qo, qr)


def test_rope_qk_matches_pallas_kernels_interpret():
    """H1's twin against both TPU kernels it replaces, run in interpret mode:
    the hd=80 unpack+rope kernel on a fused qkv view, and the text rope pair."""
    b, s, h, hd = 1, 128, 2, 80
    jc, js, _, _ = _vision_tables(b, s, hd)
    qkv = _rng(3).randn(b, s, 3 * h * hd).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jq, jk, jv = _unpack_rope_pad(jnp.asarray(qkv), jnp.asarray(jc), jnp.asarray(js), h, hd)
    tq, tk = TC.rope_qk(T(qkv)[..., : h * hd], T(qkv)[..., h * hd : 2 * h * hd], T(jc), T(js), h, h)
    unpad = lambda x: np.asarray(x).reshape(b, s, h, 128)[..., :hd].reshape(b, s, h * hd)
    close(tq, unpad(jq))
    close(tk, unpad(jk))
    np.testing.assert_array_equal(unpad(jv), qkv[..., 2 * h * hd :])

    hq, hkv, hd = 2, 1, 128
    r = _rng(4)
    q = r.randn(b, s, hq * hd).astype(np.float32)
    k = r.randn(b, s, hkv * hd).astype(np.float32)
    pos = np.cumsum(r.randint(0, 3, (3, b, s)), axis=-1).astype(np.int32)
    jc, js = JR.mrope_cos_sin(jnp.asarray(pos), hd, (16, 24, 24))
    with pltpu.force_tpu_interpret_mode():
        jq, jk = rope_pair_packed(jnp.asarray(q), jnp.asarray(k), jc, js, hq, hkv)
    tq, tk = TC.rope_qk(T(q), T(k), T(np.asarray(jc)), T(np.asarray(js)), hq, hkv)
    close(tq, jq)
    close(tk, jk)


@pytest.mark.parametrize("hd", [16, 32, 80, 128])
def test_segment_attention_matches_jax(hd):
    b, s, h = 2, 80, 2
    r = _rng(hd)
    q, k, v = (r.randn(b, s, h, hd).astype(np.float32) * 0.5 for _ in range(3))
    seg = _segments(b, s, hd)
    ref = np.asarray(_xla(JA.segment_attention, q, k, v, jnp.asarray(seg)))
    out = TA.segment_attention(T(q), T(k), T(v), T(seg))
    close(out, ref, rows=seg >= 0)
    # pad rows see no key: 0 in the port, as in the TPU kernels
    assert torch.all(out[torch.as_tensor(seg < 0)] == 0)


@pytest.mark.parametrize("hd", [16, 32, 80, 128])
def test_causal_attention_left_pad_gqa_matches_jax(hd):
    b, l, h, hkv = 2, 48, 4, 2
    r = _rng(100 + hd)
    q = r.randn(b, l, h, hd).astype(np.float32) * 0.5
    k, v = (r.randn(b, l, hkv, hd).astype(np.float32) * 0.5 for _ in range(2))
    valid = np.ones((b, l), bool)
    valid[0, :11] = False
    ref = np.asarray(_xla(JA.causal_attention, q, k, v, jnp.asarray(valid)))
    out = TA.causal_attention(T(q), T(k), T(v), T(valid))
    close(out, ref, rows=valid)


def test_segment_flash_matches_pallas_kernel_interpret():
    """H2's twin against the TPU flash kernel (interpret mode), causal with
    left padding and GQA, on all rows: both give 0 on fully masked rows."""
    b, s, h, hkv, hd = 1, 128, 2, 1, 128
    r = _rng(7)
    q = r.randn(b, s, h, hd).astype(np.float32) * 0.5
    k, v = (r.randn(b, s, hkv, hd).astype(np.float32) * 0.5 for _ in range(2))
    seg = np.zeros((b, s), np.int32)
    seg[:, :21] = -1
    with pltpu.force_tpu_interpret_mode():
        ref = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg), jnp.asarray(seg), True)
    out = TC.segment_flash_fwd(T(q), T(k), T(v), T(seg), T(seg), True, hd**-0.5)
    close(out, ref)


def test_fused_vision_attention_qkv_matches_jax():
    b, s, h, hd = 2, 128, 2, 16
    jc, js, _, _ = _vision_tables(b, s, hd)
    qkv = _rng(8).randn(b, s, 3 * h * hd).astype(np.float32)
    seg = _segments(b, s, 8, n_seg=1, pad=30)
    ref = np.asarray(_xla(JA.fused_vision_attention_qkv, jnp.asarray(qkv), jc, js, jnp.asarray(seg), h, rope_dim=hd))
    out = TA.fused_vision_attention_qkv(T(qkv), T(jc), T(js), T(seg), h, rope_dim=hd)
    close(out, ref, rows=seg >= 0)


@pytest.mark.parametrize("hd", [16, 80])
def test_window_attention_qkv_matches_jax(hd):
    b, s, h = 2, 192, 2
    jc, js, _, _ = _vision_tables(b, s, hd)
    qkv = _rng(9).randn(b, s, 3 * h * hd).astype(np.float32)
    seg = _slot_segments(b, s, hd)
    ref = np.asarray(_xla(JA.window_attention_qkv, jnp.asarray(qkv), jc, js, jnp.asarray(seg), h, win=64))
    out = TA.window_attention_qkv(T(qkv), T(jc), T(js), T(seg), h, win=64)
    close(out, ref, rows=seg >= 0)


def test_window_slot_matches_pallas_kernel_interpret():
    """H3's twin against the TPU window kernel (interpret mode) on valid rows."""
    b, s, h, hd = 1, 128, 1, 128
    jc, js, _, _ = _vision_tables(b, s, hd)
    qkv = _rng(10).randn(b, s, 3 * h * hd).astype(np.float32) * 0.5
    seg = _slot_segments(b, s, 10)
    os.environ["PADT_PALLAS"] = "1"
    try:
        with pltpu.force_tpu_interpret_mode():
            ref = JA.window_attention_qkv(jnp.asarray(qkv), jnp.asarray(jc), jnp.asarray(js), jnp.asarray(seg), h, win=64)
    finally:
        os.environ.pop("PADT_PALLAS", None)
    out = TA.window_attention_qkv(T(qkv), T(jc), T(js), T(seg), h, win=64)
    close(out, np.asarray(ref), rows=seg >= 0)


def test_plain_attention_ops_match_jax():
    r = _rng(11)
    b, c, h, hkv, d = 2, 20, 4, 2, 32
    q = r.randn(b, 1, h, d).astype(np.float32)
    kc, vc = (r.randn(b, c, hkv, d).astype(np.float32) for _ in range(2))
    valid = r.rand(b, c) > 0.3
    valid[:, 0] = True
    close(TA.decode_attention(T(q), T(kc), T(vc), T(valid)), JA.decode_attention(q, kc, vc, jnp.asarray(valid)))
    qx, kx, vx = r.randn(3, 5, 4, 16).astype(np.float32), r.randn(3, 9, 4, 16).astype(np.float32), r.randn(3, 9, 4, 16).astype(np.float32)
    qv, kv = r.rand(3, 5) > 0.2, r.rand(3, 9) > 0.2
    kv[:, 0] = True
    close(
        TA.masked_cross_attention(T(qx), T(kx), T(vx), T(qv), T(kv)),
        JA.masked_cross_attention(qx, kx, vx, jnp.asarray(qv), jnp.asarray(kv)),
        rows=qv,
    )


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    q = torch.empty((1, 64, 2, 16), dtype=torch.bfloat16, device="meta")
    seg = torch.empty((1, 64), dtype=torch.int32, device="meta")
    cs = torch.empty((1, 64, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TC.segment_flash_fwd(q, q, q, seg, seg, False, 0.25)
    with pytest.raises(ValueError, match="unsupported device"):
        TC.window_slot_attn(q, q, q, seg, 0.25)
    with pytest.raises(ValueError, match="unsupported device"):
        TC.rope_qk(q.flatten(2), None, cs, cs, 2, 0)
