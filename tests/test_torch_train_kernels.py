"""The training side of the port's kernels, on the CPU through their plain
twins, against the JAX package: H2's LSE output, the flash backward twins
(H8 dq, H9 dk/dv) and the autograd Functions around them (`flash_attention`
through `causal_attention`, `rope_pair_packed`).

Tolerance: 1e-5 relative to the reference's largest magnitude (float32 on
both sides; only the order of sums differs)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_common import close
from padt_tpu.ops import attention as JA
from padt_tpu.ops import pallas_attention as JPA
from padt_tpu_torch.ops import attention as TA
from padt_tpu_torch.ops import cuda_attention as C
from padt_tpu_torch.ops import cuda_flash_bwd as FB

T = lambda a: torch.tensor(np.asarray(a))


def _qkvg(b, s, h, hkv, d, seed):
    r = np.random.RandomState(seed)
    f = lambda *shape: r.randn(*shape).astype(np.float32)
    return f(b, s, h, d), f(b, s, hkv, d), f(b, s, hkv, d), f(b, s, h, d)


def _segs(b, s, kind):
    """Segment ids (-1 = pad): left padding, right padding, and a row with
    nothing but padding (no query sees a key)."""
    seg = np.zeros((b, s), np.int32)
    if kind == "left":
        seg[0, :37] = -1
        seg[1, :3] = -1
    elif kind == "right":
        seg[0, s - 29 :] = -1
        seg[1, s // 2 :] = 1  # two segments
        seg[1, s - 5 :] = -1
    if b > 2:
        seg[2] = -1
    return seg


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_jax_pallas_forward(causal):
    """H2's twin with return_lse vs `_flash_raw(..., return_lse=True)` in TPU
    interpret mode: the output on every row and the LSE, with +1e30 on the
    rows that see no key."""
    from jax.experimental.pallas import tpu as pltpu

    b, s, h, hkv, d = 3, 256, 4, 2, 64
    q, k, v, _ = _qkvg(b, s, h, hkv, d, 1)
    seg = _segs(b, s, "left" if causal else "right")
    with pltpu.force_tpu_interpret_mode():
        jo, jl = JPA._flash_raw(
            jnp.asarray(q.transpose(0, 2, 1, 3)), jnp.asarray(k.transpose(0, 2, 1, 3)), jnp.asarray(v.transpose(0, 2, 1, 3)),
            jnp.asarray(seg), jnp.asarray(seg), causal, d**-0.5, return_lse=True,
        )
    to, tl = C.segment_flash_fwd(T(q), T(k), T(v), T(seg), T(seg), causal, d**-0.5, return_lse=True)
    close(to, np.asarray(jo).transpose(0, 2, 1, 3))
    jl = np.asarray(jl).reshape(b, h, s)
    assert tl.shape == (b, h, s) and tl.dtype == torch.float32
    empty = jl >= 1e29
    assert empty.any() and np.array_equal(tl.numpy() >= 1e29, empty)
    close(tl.numpy()[~empty], jl[~empty])


@pytest.mark.parametrize("kind,causal", [("left", True), ("right", True), ("right", False)])
def test_bwd_twins_match_jax_xla_backward(kind, causal):
    """flash_bwd_dq / flash_bwd_dkv twins (GQA 2:1, left or right padding, a
    batch row with no visible key at all) vs `_flash_bwd_xla`, the CPU
    oracle of JAX's Pallas backward, called directly."""
    b, s, h, hkv, d = 3, 96, 4, 2, 32
    q, k, v, g = _qkvg(b, s, h, hkv, d, 2)
    seg = _segs(b, s, kind)
    scale = d**-0.5
    out, lse = C.segment_flash_fwd(T(q), T(k), T(v), T(seg), T(seg), causal, scale, return_lse=True)
    # JAX's oracle recomputes the softmax; both sides get the output of the forward
    jdq, jdk, jdv, _, _ = JPA._flash_bwd_xla(
        causal, scale, tuple(jnp.asarray(x) for x in (q, k, v, seg, seg, out.numpy())), jnp.asarray(g))
    delta = (T(g) * out).sum(-1).transpose(1, 2).contiguous()
    args = (T(q), T(k), T(v), T(g), T(seg), T(seg), lse, delta, causal, scale)
    dq = FB.flash_bwd_dq(*args)
    dk, dv = FB.flash_bwd_dkv(*args)
    close(dq, np.asarray(jdq))
    assert float(dq[~torch.as_tensor(seg >= 0)].abs().max()) == 0.0  # a pad query row: p = 0
    close(dk, np.asarray(jdk))
    close(dv, np.asarray(jdv))


def test_bwd_twins_match_jax_pallas_backward():
    """The same against `_flash_bwd_pallas` (K11 + K12) run in TPU interpret
    mode on one 128-block, with the LSE the JAX forward saved."""
    from jax.experimental.pallas import tpu as pltpu

    b, s, h, hkv, d = 2, 128, 2, 1, 32
    q, k, v, g = _qkvg(b, s, h, hkv, d, 3)
    seg = _segs(b, s, "left")
    scale = d**-0.5
    with pltpu.force_tpu_interpret_mode():
        jo, jl = JPA._flash_raw(
            jnp.asarray(q.transpose(0, 2, 1, 3)), jnp.asarray(k.transpose(0, 2, 1, 3)), jnp.asarray(v.transpose(0, 2, 1, 3)),
            jnp.asarray(seg), jnp.asarray(seg), True, scale, return_lse=True,
        )
        jo = jo.transpose(0, 2, 1, 3)
        jdq, jdk, jdv, _, _ = JPA._flash_bwd_pallas(
            True, scale, tuple(jnp.asarray(x) for x in (q, k, v, seg, seg)) + (jo, jl), jnp.asarray(g))
    out, lse = C.segment_flash_fwd(T(q), T(k), T(v), T(seg), T(seg), True, scale, return_lse=True)
    delta = (T(g) * out).sum(-1).transpose(1, 2).contiguous()
    args = (T(q), T(k), T(v), T(g), T(seg), T(seg), lse, delta, True, scale)
    close(FB.flash_bwd_dq(*args), np.asarray(jdq))
    dk, dv = FB.flash_bwd_dkv(*args)
    close(dk, np.asarray(jdk))
    close(dv, np.asarray(jdv))


def test_bwd_twins_match_jax_pallas_backward_over_several_blocks():
    """The same on a non-causal layout of several segments and right padding
    at hd 80, S = 896, where `_pick_block` gives JAX 128-blocks: seven
    q-blocks and k-blocks, so `_kblock_ranges` cuts each kernel's loop."""
    from jax.experimental.pallas import tpu as pltpu

    b, s, h, hkv, d = 1, 896, 2, 1, 80
    assert JPA._pick_block(s) == 128
    q, k, v, g = _qkvg(b, s, h, hkv, d, 6)
    seg = np.repeat(np.arange(7, dtype=np.int32), 128)[None] // 2  # 256-token segments, one 128-token last
    seg[:, 700:] = -1
    scale = d**-0.5
    with pltpu.force_tpu_interpret_mode():
        jo, jl = JPA._flash_raw(
            jnp.asarray(q.transpose(0, 2, 1, 3)), jnp.asarray(k.transpose(0, 2, 1, 3)), jnp.asarray(v.transpose(0, 2, 1, 3)),
            jnp.asarray(seg), jnp.asarray(seg), False, scale, return_lse=True,
        )
        jo = jo.transpose(0, 2, 1, 3)
        jdq, jdk, jdv, _, _ = JPA._flash_bwd_pallas(
            False, scale, tuple(jnp.asarray(x) for x in (q, k, v, seg, seg)) + (jo, jl), jnp.asarray(g))
    out, lse = C.segment_flash_fwd(T(q), T(k), T(v), T(seg), T(seg), False, scale, return_lse=True)
    delta = (T(g) * out).sum(-1).transpose(1, 2).contiguous()
    args = (T(q), T(k), T(v), T(g), T(seg), T(seg), lse, delta, False, scale)
    dq = FB.flash_bwd_dq(*args)
    close(dq, np.asarray(jdq))
    assert float(dq[0, 700:].abs().max()) == 0.0
    dk, dv = FB.flash_bwd_dkv(*args)
    close(dk, np.asarray(jdk))
    close(dv, np.asarray(jdv))
    assert float(dk[0, 700:].abs().max()) == 0.0 and float(dv[0, 700:].abs().max()) == 0.0


def test_causal_attention_grads_match_jax():
    """Gradients of a loss weighted on the valid rows, through JAX's
    causal_attention (XLA branch) and the port's (the flash_attention
    Function: twin forward with LSE, H8/H9 twins backward)."""
    b, s, h, hkv, d = 3, 40, 4, 2, 16
    q, k, v, w = _qkvg(b, s, h, hkv, d, 4)
    valid = _segs(b, s, "left")[:, :] >= 0
    valid[2, 5:] = True  # the third row has keys here
    wm = (w * valid[:, :, None, None]).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(JA.causal_attention(q, k, v, jnp.asarray(valid)) * wm)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (T(x).requires_grad_() for x in (q, k, v))
    out = TA.causal_attention(tq, tk, tv, T(valid))
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    (out * T(wm)).sum().backward()
    for t, j in zip((tq, tk, tv), jg):
        close(t.grad, np.asarray(j))
    with torch.no_grad():  # inference keeps the plain forward call
        assert TA.causal_attention(tq, tk, tv, T(valid)).grad_fn is None


@pytest.mark.parametrize("with_k", [True, False])
def test_rope_pair_packed_grads_match_jax(with_k):
    """The rope Function (H1's twin forward, H1 with -sin backward) vs
    jax.grad through `rope_pair_packed` (Pallas in interpret mode) on the
    M-RoPE tables of the text stack; cos/sin get no gradient."""
    from jax.experimental.pallas import tpu as pltpu

    from padt_tpu.ops.rope import mrope_cos_sin

    b, s, h, hkv, d = 2, 128, 4, 2, 128
    r = np.random.RandomState(5)
    q, k = r.randn(b, s, h * d).astype(np.float32), r.randn(b, s, hkv * d).astype(np.float32)
    wq, wk = r.randn(b, s, h * d).astype(np.float32), r.randn(b, s, hkv * d).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None, None], (3, b, s)).copy()
    pos[1, :, 10:30] += 3
    cos, sin = (np.asarray(t) for t in mrope_cos_sin(jnp.asarray(pos), d, (16, 24, 24), 1e6))

    def jloss(q, k):
        qr, kr = JPA.rope_pair_packed(q, k, jnp.asarray(cos), jnp.asarray(sin), h, hkv)
        return jnp.sum(qr * wq) + (jnp.sum(kr * wk) if with_k else 0.0)

    with pltpu.force_tpu_interpret_mode():
        jgq, jgk = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))
    tq, tk = T(q).requires_grad_(), T(k).requires_grad_()
    tc, ts = T(cos).requires_grad_(), T(sin).requires_grad_()
    if with_k:
        qr, kr = TA.rope_pair_packed(tq, tk, tc, ts, h, hkv)
        ((qr * T(wq)).sum() + (kr * T(wk)).sum()).backward()
        close(tk.grad, np.asarray(jgk))
    else:
        qr, none = TA.rope_pair_packed(tq, None, tc, ts, h, 0)
        assert none is None
        (qr * T(wq)).sum().backward()
    close(tq.grad, np.asarray(jgq))
    assert tc.grad is None and ts.grad is None
