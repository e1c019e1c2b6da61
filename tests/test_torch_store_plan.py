"""H6 (`store_kv_rows`) on the CPU: its pure-Python launch plan
(`ops.cuda_kv.store_plan`) at every main-path shape, a numpy replay of the
kernel's thread mapping and copy rule against the twin, the all-layer
stores against JAX's `store_kv_rows_all_layers` /
`store_kv_rows_k_all_layers`, including the edges (n_rows 0, positions at
C - 1 and past C), and the new rows as `int8_layers` hands them to H6:
quantized straight into one stacked buffer, byte-identical to stacking
each layer's `quantize_kv` output. The kernel itself runs on the card
(tests/test_torch_kernels.py)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_common import jax_mode
from padt_tpu.ops import kv_cache as JK
from padt_tpu_torch import padt_3b, padt_7b, padt_tiny
from padt_tpu_torch.models import language as TL
from padt_tpu_torch.ops import cuda_kv as K
from padt_tpu_torch.ops import kv_cache as TK
from padt_tpu_torch.ops.rope import mrope_cos_sin

T = lambda a: torch.as_tensor(np.array(a))
KEYS = ("k8", "ks", "v8", "vs")

_3B, _7B = padt_3b().text, padt_7b().text
# (layers, slots, kv heads, rows per slot, hd): the 3B serve pool (8 slots) and chip_smoke's 16-slot lines at
# decode (n = 1), speculative verify (kq = 4) and the suffix pass (kq = 32); PaDT-7B's decode and verify;
# [forms]' one-layer views (K17 / K18)
SHAPES = [
    (_3B.num_hidden_layers, b, _3B.num_key_value_heads, kq, _3B.head_dim) for b in (8, 16) for kq in (1, 4, 32)
] + [(_7B.num_hidden_layers, 8, _7B.num_key_value_heads, kq, _7B.head_dim) for kq in (1, 4)] + [
    (1, 16, _3B.num_key_value_heads, kq, _3B.head_dim) for kq in (1, 32)
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_store_plan_covers_every_chunk_once(shape):
    nl, b, hkv, kq, hd = shape
    plan = K.store_plan(nl, b, hkv, kq, hd)
    assert plan.block in K.STORE_BLOCKS and plan.rpt in K.STORE_RPTS and plan.rpt <= kq and plan.pdl
    assert plan.threads == 2 * nl * b * hkv * -(-kq // plan.rpt) * hd // 16 < 2**31
    assert plan.ctas * plan.block >= plan.threads > (plan.ctas - 1) * plan.block
    if plan.rpt > 1:  # more rows a thread only while the threads still fill every SM
        assert plan.threads >= K.SMS * K.STORE_SM_THREADS
    if plan.threads >= K.SMS * K.STORE_BLOCKS[-1]:  # every SM gets a CTA wherever the smallest block allows
        assert plan.ctas >= K.SMS
    if plan.block != K.STORE_BLOCKS[0]:  # a larger block would have left SMs without a CTA
        bigger = K.STORE_BLOCKS[K.STORE_BLOCKS.index(plan.block) - 1]
        assert -(-plan.threads // bigger) < K.SMS
    for rpt in K.STORE_RPTS:  # every instance covers each (layer, slot, head, row, K/V, chunk) once
        cand = K.store_plan(nl, b, hkv, kq, hd, rpt=rpt)
        l, s, h, j, kv, e = cand.units(np.arange(cand.threads))
        flat = ((((l * b + s) * hkv + h) * kq + j) * 2 + kv) * cand.chunks + e
        assert np.array_equal(np.sort(flat), np.arange(2 * nl * b * hkv * kq * cand.chunks)), rpt


def _case(rng, nl, b, hkv, c, hd, kq):
    i8 = lambda *s: rng.randint(-127, 128, s).astype(np.int8)
    sc = lambda *s: rng.lognormal(-4, 0.4, s).astype(np.float32)
    cache = dict(k8=i8(nl, b, hkv, c, hd), ks=sc(nl, b, hkv, c), v8=i8(nl, b, hkv, c, hd), vs=sc(nl, b, hkv, c))
    new = dict(k8r=i8(nl, b, hkv, kq, hd), ksr=sc(nl, b, hkv, kq), v8r=i8(nl, b, hkv, kq, hd), vsr=sc(nl, b, hkv, kq))
    return cache, new


def _replay(plan, cache, new, pos, n_rows):
    """The kernel's copy rule over the plan's threads, in numpy: thread t
    copies its 16-byte chunk (and, at chunk 0, its row's scale) when row j <
    n_rows[b] and its position lies in [0, C)."""
    out = {k: v.copy() for k, v in cache.items()}
    c = cache["k8"].shape[3]
    l, s, h, j, kv, e = plan.units(np.arange(plan.threads))
    row = pos[s] + j
    keep = (j < np.minimum(n_rows[s], plan.kq)) & (row >= 0) & (row < c)
    l, s, h, j, kv, e, row = (x[keep] for x in (l, s, h, j, kv, e, row))
    for which, (buf, sbuf, src, ssrc) in enumerate((("k8", "ks", "k8r", "ksr"), ("v8", "vs", "v8r", "vsr"))):
        m = kv == which
        lm, sm, hm, jm, em, rm = (x[m] for x in (l, s, h, j, e, row))
        cols = em[:, None] * 16 + np.arange(16)[None, :]
        out[buf][lm[:, None], sm[:, None], hm[:, None], rm[:, None], cols] = new[src][lm[:, None], sm[:, None], hm[:, None], jm[:, None], cols]
        z = em == 0
        out[sbuf][lm[z], sm[z], hm[z], rm[z]] = new[ssrc][lm[z], sm[z], hm[z], jm[z]]
    return out


@pytest.mark.parametrize("kq", [1, 4, 32])
def test_replay_of_the_kernel_matches_the_twin(kq):
    """Every kernel instance (rows a thread): n_rows 0, partial and kq;
    positions at 0, C - kq, C - 1 (rows past C dropped), and negative (rows
    below 0 dropped)."""
    rng = np.random.RandomState(kq)
    nl, b, hkv, c, hd = 3, 6, 2, 70, 32
    cache, new = _case(rng, nl, b, hkv, c, hd, kq)
    pos = np.array([0, c - kq, c - 1, -2, 33, 5], np.int32)
    n_rows = np.array([kq, kq, kq, kq, 0, max(kq // 2, 1)], np.int32)
    ref = {k: T(v).clone() for k, v in cache.items()}
    K.store_kv_rows_plain(*ref.values(), *(T(new[k]) for k in new), T(pos), T(n_rows))
    for rpt in K.STORE_RPTS:
        got = _replay(K.store_plan(nl, b, hkv, kq, hd, rpt=rpt), cache, new, pos, n_rows)
        for k in KEYS:
            np.testing.assert_array_equal(got[k], ref[k].numpy(), err_msg=f"{k}, {rpt} rows a thread")
        np.testing.assert_array_equal(got["k8"][:, 4], cache["k8"][:, 4])  # n_rows 0: the slot keeps every byte


@pytest.mark.parametrize("mode", ["xla", "pallas"])
@pytest.mark.parametrize("kq", [1, 5])
def test_all_layer_stores_match_jax(mode, kq):
    """The op-level all-layer stores equal JAX's at the positions its
    contract covers (pos <= C - kq: past it JAX's dynamic_update_slice
    moves the rows back into range, the port drops those past C); past
    C - kq (to C - 1) a slot with n_rows 0 keeps every byte, and at one row
    C - 1 is inside JAX's contract."""
    rng = np.random.RandomState(10 + kq)
    nl, b, hkv, c, hd = 3, 5, 2, 128, 128
    cache, new = _case(rng, nl, b, hkv, c, hd, kq)
    n_rows = T(np.array([kq, max(kq - 2, 1), kq, kq, 0], np.int32))
    rows = [T(new[k]) for k in new]
    jnew = [jnp.asarray(new[k]) for k in new]

    def store(pos):
        buf = [T(cache[k]).clone() for k in KEYS]
        if kq == 1:
            out = TK.store_kv_rows_all_layers(*buf, *rows, T(pos))
        else:
            out = TK.store_kv_rows_k_all_layers(*buf, *rows, T(pos), n_rows=n_rows)
        assert all(o is t for o, t in zip(out, buf))  # in place
        return buf

    def jax_store(pos):
        jc = [jnp.asarray(cache[k]) for k in KEYS]
        with jax_mode(mode):
            if kq == 1:
                return JK.store_kv_rows_all_layers(*jc, *jnew, jnp.asarray(pos))
            return JK.store_kv_rows_k_all_layers(*jc, *jnew, jnp.asarray(pos), n_rows=jnp.asarray(n_rows.numpy()))

    inside = np.array([0, 31, c - kq, c - kq, 97], np.int32)
    edges = np.array([0, 31, c - kq, c - 1, 97], np.int32)
    for k, x, r in zip(KEYS, store(inside), jax_store(inside)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(r), err_msg=k)
    got = store(edges)
    if kq > 1:  # n_rows 0: every byte kept
        for k, x in zip(KEYS, got):
            np.testing.assert_array_equal(x[:, 4].numpy(), cache[k][:, 4], err_msg=k)
    else:
        for k, x, r in zip(KEYS, got, jax_store(edges)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(r), err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 4])
def test_quantize_kv_into_a_slice_matches_quantize_kv(dtype, n):
    """quantize_kv(x, out=) writes the bytes quantize_kv(x) returns, into a
    layer's slice of a stacked buffer, for the transposed K/V views that
    int8_layers hands it (all-zero rows included)."""
    rng = np.random.RandomState(n)
    b, hkv, hd, nl = 3, 2, 32, 4
    x = torch.as_tensor(rng.standard_normal((b, n, hkv, hd)).astype(np.float32) * 3).to(dtype)
    x[1, 0] = 0
    q8 = torch.full((nl, b, hkv, n, hd), 55, dtype=torch.int8)
    sc = torch.full((nl, b, hkv, n), 7.0)
    ref = TK.quantize_kv(x.transpose(1, 2))
    got = TK.quantize_kv(x.transpose(1, 2), out=(q8[2], sc[2]))
    assert got[0].data_ptr() == q8[2].data_ptr() and got[1].data_ptr() == sc[2].data_ptr()
    assert torch.equal(q8[2], ref[0]) and torch.equal(sc[2], ref[1])
    assert bool((q8[[0, 1, 3]] == 55).all()) and bool((sc[[0, 1, 3]] == 7.0).all())  # the other layers untouched


@pytest.mark.parametrize("n", [1, 4])
def test_int8_layers_rows_need_no_stack(n):
    """int8_layers returns every layer's new rows stacked, byte-identical
    to stacking each layer's quantize_kv output (the form H6 read before),
    with the same hidden states; the fresh columns each layer's attention
    gets are views of the stacked buffers, so no copy stacks them."""
    cfg = padt_tiny().text
    g = torch.Generator().manual_seed(n)
    params = TL.init_text_params(cfg, g, "cpu", torch.float32)
    b = 3
    x = torch.randn((b, n, cfg.hidden_size), generator=g)
    pos = (torch.arange(n)[None, None, :] + torch.tensor([5, 9, 17])[None, :, None]).expand(3, b, n)
    cos, sin = mrope_cos_sin(pos, cfg.head_dim, cfg.mrope_section, cfg.rope_theta)
    seen = []

    def attend(q, li, fresh):
        seen.append(fresh)
        return q

    hidden, rows = TL.int8_layers(params, cfg, x, cos, sin, attend)
    ref_rows = []
    y = x
    for li in range(cfg.num_hidden_layers):  # the loop as it stacked the rows after it
        lp = TL._layer(params, li)
        q, k, v = TL._qkv_rot(TL.rms_norm(y, lp["input_ln_w"], cfg.rms_norm_eps), lp, cfg, cos, sin)
        ref_rows.append((*TK.quantize_kv(k.transpose(1, 2)), *TK.quantize_kv(v.transpose(1, 2))))
        y = y + TL.qlinear(lp, "o_w", q.reshape(b, n, -1))
        y = y + TL._mlp(TL.rms_norm(y, lp["post_ln_w"], cfg.rms_norm_eps), lp)
    ref_hidden = TL.rms_norm(y, params["final_ln_w"], cfg.rms_norm_eps)
    assert torch.equal(hidden, ref_hidden)
    nl, hkv, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    for i, (got, ref) in enumerate(zip(rows, (torch.stack(t) for t in zip(*ref_rows)))):
        assert got.shape == ((nl, b, hkv, n, hd) if i % 2 == 0 else (nl, b, hkv, n)) and got.is_contiguous()
        assert torch.equal(got, ref), KEYS[i]
        assert [f[i].data_ptr() for f in seen] == [t.data_ptr() for t in got.unbind(0)]
