"""The port's int8 KV cache ops (`padt_tpu_torch.ops.kv_cache` and the plain
twins of H4 / H5 / H6 in `ops.cuda_kv`) vs `padt_tpu.ops.kv_cache` on the
CPU, on the same seeded numpy inputs.

Against the JAX plain branches (PADT_PALLAS=0) with float32 queries: 1e-4
relative to the output's magnitude (both sides float32 with bf16 roundings
in the same places; a probability that rounds to the other bf16 neighbour
moves the output by far less). Against the Pallas kernels in TPU interpret
mode with bf16 queries: 2e-2 absolute on bf16 outputs of magnitude ~1 (the
tolerance of tests/test_kv_cache.py). Row stores: byte-identical.
quantize_kv: an int8 value may differ by one quantum at a rounding
boundary, scales within 1e-6 relative."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_common import jax_mode
from padt_tpu.ops import kv_cache as JK
from padt_tpu_torch.ops import cuda_kv
from padt_tpu_torch.ops import kv_cache as TK

T = lambda a: torch.as_tensor(np.array(a))


def _rel_close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= tol * (1.0 + np.abs(b).max()), (np.abs(a - b).max(), np.abs(b).max())


def _cache(rng, nl, b, hkv, c, hd, kq):
    """Random int8 cache (L, B, Hkv, C, hd) with scales, and kq fresh rows."""
    i8 = lambda *s: rng.randint(-127, 128, s).astype(np.int8)
    sc = lambda *s: rng.lognormal(-4, 0.4, s).astype(np.float32)
    return dict(
        k8=i8(nl, b, hkv, c, hd), ks=sc(nl, b, hkv, c), v8=i8(nl, b, hkv, c, hd), vs=sc(nl, b, hkv, c),
        k8n=i8(b, hkv, kq, hd), ksn=sc(b, hkv, kq), v8n=i8(b, hkv, kq, hd), vsn=sc(b, hkv, kq),
    )


def _valid(b, c):
    """Left padding, an unwritten tail, an odd live length, and a slot with no
    live cache row (its queries see only the fresh columns)."""
    v = np.zeros((b, c), bool)
    v[0, 17 : c // 2] = True
    v[1, : c - 3] = True
    v[2, 5:6] = True
    # row 3 stays empty
    return v


def test_quantize_kv_matches_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 7, 128) * rng.lognormal(size=(3, 5, 7, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: scale 1e-8 / 127
    jq, js = JK.quantize_kv(jnp.asarray(x))
    tq, ts = TK.quantize_kv(T(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and tq.shape == x.shape
    d = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    assert float(ts[0, 0, 0]) == TK.empty_scale()
    # round half to even, as jnp.round
    half = torch.tensor([[0.5, 1.5, 2.5, -0.5, 127.0]])
    assert TK.quantize_kv(half)[0].tolist() == [[0, 2, 2, 0, 127]]


@pytest.mark.parametrize("mode", ["xla", "pallas"])
def test_int8_decode_twin_matches_jax(mode):
    rng = np.random.RandomState(1)
    nl, b, hkv, g, hd, c, li = 3, 4, 2, 4, 128, 256, 1
    t = _cache(rng, nl, b, hkv, c, hd, 1)
    valid = _valid(b, c)
    q = rng.randn(b, 1, hkv * g, hd).astype(np.float32) * 0.5
    if mode == "pallas":
        q = np.asarray(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    tq = T(q) if mode == "xla" else T(q).to(torch.bfloat16)
    jq = jnp.asarray(q) if mode == "xla" else jnp.asarray(q, jnp.bfloat16)
    fresh = lambda f: tuple(f(t[k]) for k in ("k8n", "ksn", "v8n", "vsn"))
    cache = lambda f: tuple(f(t[k]) for k in ("k8", "ks", "v8", "vs"))
    got = TK.decode_attention_int8(tq, *cache(T), T(valid), layer=li, fresh_kv=fresh(T))
    assert got.shape == (b, 1, hkv * g, hd) and got.dtype == tq.dtype
    with jax_mode(mode):
        if mode == "xla":
            ref = JK.decode_attention_int8(jq, *cache(jnp.asarray), jnp.asarray(valid), layer=li, fresh_kv=fresh(jnp.asarray))
            _rel_close(got.numpy(), ref, 1e-4)
        else:
            qg = jq.reshape(b, hkv, g, hd)
            args = (*cache(jnp.asarray), *fresh(jnp.asarray), jnp.asarray(valid, jnp.int32), li)
            for ref in (JK._decode_attention_int8_pallas_stacked_fresh(qg, *args),
                        JK._decode_attention_int8_pallas_stacked_fresh_bb(qg, *args[:-1], li, 2)):
                err = np.abs(got.float().numpy().reshape(b, hkv, g, hd) - np.asarray(ref, np.float32)).max()
                assert err <= 2e-2, err


@pytest.mark.parametrize("mode,kq", [("xla", 1), ("xla", 4), ("xla", 32), ("pallas", 4)])
def test_int8_verify_twin_matches_jax(mode, kq):
    rng = np.random.RandomState(2 + kq)
    nl, b, hkv, g, hd, c, li = 2, 4, 2, 4, 128, 160, 1
    t = _cache(rng, nl, b, hkv, c, hd, kq)
    valid = _valid(b, c)
    q = rng.randn(b, kq, hkv * g, hd).astype(np.float32) * 0.5
    tq = T(q) if mode == "xla" else T(q).to(torch.bfloat16)
    jq = jnp.asarray(q) if mode == "xla" else jnp.asarray(q, jnp.bfloat16)
    fresh = lambda f: tuple(f(t[k]) for k in ("k8n", "ksn", "v8n", "vsn"))
    cache = lambda f: tuple(f(t[k]) for k in ("k8", "ks", "v8", "vs"))
    wp = np.array([c // 2, c - 3, 6, 0], np.int32)
    got = TK.decode_attention_int8_multi(tq, *cache(T), T(valid), T(wp), layer=li, fresh_kv=fresh(T))
    assert got.shape == (b, kq, hkv * g, hd)
    with jax_mode(mode):
        ref = JK.decode_attention_int8_multi(jq, *cache(jnp.asarray), jnp.asarray(valid), jnp.asarray(wp), layer=li, fresh_kv=fresh(jnp.asarray))
    if mode == "xla":
        _rel_close(got.numpy(), ref, 1e-4)
    else:
        assert np.abs(got.float().numpy() - np.asarray(ref, np.float32)).max() <= 2e-2


def _store_case(rng, kq):
    nl, b, hkv, c, hd = 3, 5, 2, 128, 32
    t = _cache(rng, nl, b, hkv, c, hd, kq)
    new = dict(
        k8r=rng.randint(-127, 128, (nl, b, hkv, kq, hd)).astype(np.int8),
        ksr=rng.rand(nl, b, hkv, kq).astype(np.float32),
        v8r=rng.randint(-127, 128, (nl, b, hkv, kq, hd)).astype(np.int8),
        vsr=rng.rand(nl, b, hkv, kq).astype(np.float32),
    )
    return t, new, c


@pytest.mark.parametrize("mode", ["xla", "pallas"])
def test_store_rows_twin_matches_jax(mode):
    """K7 (one row per slot; positions at tile boundaries and at the clamp
    min(write_pos, C-1)) and K9 (kq rows, n_rows in {0, partial, kq},
    positions straddling 32-row tiles and at the clamp C - kq), in place."""
    rng = np.random.RandomState(3)
    keys = ("k8", "ks", "v8", "vs")

    t, new, c = _store_case(rng, 1)
    pos = np.array([0, 31, 32, 97, c - 1], np.int32)
    cache = {k: T(t[k]).clone() for k in keys}
    out = TK.store_kv_rows_all_layers(*cache.values(), *(T(new[k]) for k in new), T(pos))
    assert all(o is cache[k] for o, k in zip(out, keys))  # in place
    with jax_mode(mode):
        ref = JK.store_kv_rows_all_layers(*(jnp.asarray(t[k]) for k in keys), *(jnp.asarray(new[k]) for k in new), jnp.asarray(pos))
    for k, r in zip(keys, ref):
        np.testing.assert_array_equal(cache[k].numpy(), np.asarray(r), err_msg=k)

    kq = 5
    t, new, c = _store_case(rng, kq)
    pos = np.array([3, 30, 60, c - kq, c - kq], np.int32)
    n_rows = np.array([kq, 2, 0, kq, 0], np.int32)
    cache = {k: T(t[k]).clone() for k in keys}
    TK.store_kv_rows_k_all_layers(*cache.values(), *(T(new[k]) for k in new), T(pos), n_rows=T(n_rows))
    with jax_mode(mode):
        ref = JK.store_kv_rows_k_all_layers(
            *(jnp.asarray(t[k]) for k in keys), *(jnp.asarray(new[k]) for k in new), jnp.asarray(pos), n_rows=jnp.asarray(n_rows),
        )
    for k, r in zip(keys, ref):
        np.testing.assert_array_equal(cache[k].numpy(), np.asarray(r), err_msg=k)
    for s in (2, 4):  # n_rows 0: every byte of the slot stays
        for k in keys:
            np.testing.assert_array_equal(cache[k][:, s].numpy(), t[k][:, s], err_msg=f"{k} slot {s}")
    # without n_rows every slot takes all kq rows
    cache = {k: T(t[k]).clone() for k in keys}
    TK.store_kv_rows_k_all_layers(*cache.values(), *(T(new[k]) for k in new), T(pos))
    np.testing.assert_array_equal(cache["k8"][:, 2, :, 60 : 60 + kq].numpy(), new["k8r"][:, 2])


def test_cpu_calls_take_the_twins_and_unported_forms_raise():
    rng = np.random.RandomState(4)
    t = _cache(rng, 1, 2, 2, 64, 32, 1)
    cuda_kv.reset_launch_counts()
    q = torch.randn(2, 1, 4, 32)
    args = [T(t[k]) for k in ("k8", "ks", "v8", "vs")] + [torch.ones(2, 64, dtype=torch.bool)]
    fresh = tuple(T(t[k]) for k in ("k8n", "ksn", "v8n", "vsn"))
    TK.decode_attention_int8(q, *args, layer=0, fresh_kv=fresh)
    assert all(n == 0 for n in cuda_kv.launch_counts.values())  # a twin is no launch
    TK.decode_attention_int8(q, *args, layer=0, fresh_kv=fresh, quantize_q=True)
    assert all(n == 0 for n in cuda_kv.launch_counts.values())
    # quantize_q stays refused where JAX refuses it: without fresh_kv, and in the multi-query form
    with pytest.raises(NotImplementedError, match="quantize_q"):
        TK.decode_attention_int8(q, *args, layer=0, quantize_q=True)
    with pytest.raises(NotImplementedError, match="quantize_q"):
        TK.decode_attention_int8_multi(q, *args, torch.zeros(2, dtype=torch.int32), layer=0, fresh_kv=fresh, quantize_q=True)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_kv.int8_decode_attn(q.to("meta"), *args[:4], *fresh, args[4], 0)


def test_attention_launch_geometry():
    """The attention kernels' column split (CTAs per cluster) fills the card
    at decode and at a suffix pass (two 64-row tiles a CTA, 2 CTAs per
    slot and kv head; a pass's CTA keeps at least 3 column tiles), and their
    shared memory fits a Hopper block at the serve path's capacity."""
    assert cuda_kv.attn_plan("decode", 8, 2, 8, 768, 128, 1).split == 8  # decode: 8 slots x 2 kv heads x G = 8 rows
    sfx = cuda_kv.attn_plan("verify", 16, 2, 8 * 32, 768, 128, 32)  # suffix pass: kq = 32
    assert sfx.split == 2 and sfx.row_tiles == 2 and sfx.ctas * sfx.row_tiles >= 256  # 8 warps on each SM
    assert cuda_kv.attn_plan("verify", 3, 2, 8 * 16, 768, 128, 16).split == 4  # each CTA keeps >= 3 tiles
    for kind in ("decode", "verify"):
        for split in (1, 2, 4, 8):
            assert cuda_kv.attn_smem_bytes(kind, 128, 2, -(-768 // split), 32) <= cuda_kv._SMEM_LIMIT
    assert cuda_kv.attn_smem_bytes("decode", 128, 2, 96) < cuda_kv.attn_smem_bytes("decode", 128, 2, 768)
