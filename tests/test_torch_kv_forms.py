"""The older int8 KV forms of the port (`padt_tpu_torch.ops.kv_cache` without
`fresh_kv`, and the single-layer stores) vs `padt_tpu.ops.kv_cache` on the
CPU, on the same seeded numpy inputs with bf16 queries: K13 (unstacked
decode), K14 (`layer=`), K15 (`n_valid=`), K16 (the multi-query form over a
cache that holds the new rows, unstacked and `layer=`), K17 / K18
(`store_kv_rows`, `store_kv_rows_k`, unstacked and `layer=`).

The JAX side runs as its own tests run it: the plain branches (PADT_PALLAS=0,
"xla") and the Pallas kernels in TPU interpret mode ("pallas").

Tolerances: the bf16 outputs within one bf16 ulp of the largest output
magnitude (both sides sum in fp32 with the bf16 roundings in the same
places; only the order of the sums differs, which can move an output to the
neighbouring bf16 value). Stores: byte-identical."""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_common import jax_mode
from padt_tpu.ops import kv_cache as JK
from padt_tpu_torch.ops import kv_cache as TK

T = lambda a: torch.as_tensor(np.array(a))
KEYS = ("k8", "ks", "v8", "vs")


def _ulp_close(got, ref, rows=slice(None)):
    """|got - ref| <= one bf16 ulp of ref's largest magnitude, on `rows`."""
    a = got.float().numpy()[rows]
    r = np.asarray(ref, np.float32)[rows]
    mag = float(np.abs(r).max())
    ulp = 2.0 ** (math.floor(math.log2(mag)) - 7)
    assert np.abs(a - r).max() <= ulp, (float(np.abs(a - r).max()), ulp)


def _inputs(rng, b, hkv, g, hd, c, nl=None, kq=1):
    """A random int8 cache with scales (stacked when nl is given) and bf16
    queries, as numpy (the queries rounded to bf16 values)."""
    lead = (b, hkv, c) if nl is None else (nl, b, hkv, c)
    i8 = lambda *s: rng.randint(-127, 128, s).astype(np.int8)
    sc = lambda *s: rng.lognormal(-4, 0.4, s).astype(np.float32)
    t = dict(k8=i8(*lead, hd), ks=sc(*lead), v8=i8(*lead, hd), vs=sc(*lead))
    q = np.asarray(jnp.asarray(rng.randn(b, kq, hkv * g, hd) * 0.5, jnp.bfloat16).astype(jnp.float32))
    return t, q


def _valid(b, c):
    """Left padding, an unwritten tail, one live row, and a slot with no
    valid key (its rows give the mean of the V rows: the softmax over all
    -1e30 scores is uniform)."""
    v = np.zeros((b, c), bool)
    v[0, 17 : c // 2] = True
    v[1, : c - 3] = True
    v[2, 5:6] = True
    return v


def _tq(q):
    return T(q).to(torch.bfloat16)


@pytest.mark.parametrize("mode", ["xla", "pallas"])
@pytest.mark.parametrize("stacked", [False, True])
def test_decode_without_fresh_matches_jax(mode, stacked):
    """K13 (unstacked) and K14 (layer= on a 3-layer stack), every valid
    pattern of _valid, slot 3 with no valid key."""
    rng = np.random.RandomState(11 + stacked)
    b, hkv, g, hd, c, li = 4, 2, 4, 128, 256, 2
    t, q = _inputs(rng, b, hkv, g, hd, c, nl=3 if stacked else None)
    valid = _valid(b, c)
    kw = dict(layer=li) if stacked else {}
    got = TK.decode_attention_int8(_tq(q), *(T(t[k]) for k in KEYS), T(valid), **kw)
    assert got.shape == (b, 1, hkv * g, hd) and got.dtype == torch.bfloat16
    with jax_mode(mode):
        ref = JK.decode_attention_int8(jnp.asarray(q, jnp.bfloat16), *(jnp.asarray(t[k]) for k in KEYS), jnp.asarray(valid), **kw)
    _ulp_close(got, ref)
    lv = (lambda k: t[k][li]) if stacked else (lambda k: t[k])
    mean = (lv("v8")[3].astype(np.float32) * lv("vs")[3][..., None]).mean(axis=1)  # (Hkv, hd)
    assert np.abs(got[3, 0].float().numpy().reshape(hkv, g, hd) - mean[:, None]).max() < 1e-2


@pytest.mark.parametrize("case", ["pallas", "xla_live_rows", "capacity_not_a_tile_multiple"])
def test_tiled_decode_matches_jax(case):
    """K15: n_valid at a sub-tile length, a 256-row tile edge, across tiles,
    the full length, and 0 (no live key: 0, as the kernel's l > 0 guard
    gives). The JAX plain branch ignores n_valid (K13's semantics): it agrees
    on every slot with a live key. A capacity that is no multiple of 256
    gives K13 on both sides."""
    rng = np.random.RandomState(21)
    b, hkv, g, hd = 5, 2, 4, 128
    c = 384 if case == "capacity_not_a_tile_multiple" else 512
    t, q = _inputs(rng, b, hkv, g, hd, c)
    nv = np.array([100, 256, 257, c, 0], np.int32)
    cols = np.arange(c)[None, :]
    valid = (cols < nv[:, None]) & (cols >= 3)
    got = TK.decode_attention_int8(_tq(q), *(T(t[k]) for k in KEYS), T(valid), n_valid=T(nv))
    with jax_mode("xla" if case == "xla_live_rows" else "pallas"):
        ref = JK.decode_attention_int8(jnp.asarray(q, jnp.bfloat16), *(jnp.asarray(t[k]) for k in KEYS), jnp.asarray(valid),
                                       n_valid=jnp.asarray(nv))
    if case == "pallas":
        _ulp_close(got, ref)
        assert float(got[4].float().abs().max()) == 0.0
    elif case == "xla_live_rows":
        _ulp_close(got, ref, rows=slice(0, 4))
    else:
        _ulp_close(got, ref)
        assert float(got[4].float().abs().max()) > 0.0  # K13: the mean of the V rows


@pytest.mark.parametrize("mode", ["xla", "pallas"])
@pytest.mark.parametrize("stacked", [False, True])
def test_multi_without_fresh_matches_jax(mode, stacked):
    """K16: the K new rows already in the cache and in `valid`; write_pos
    inside a 32-row tile, across one, at the end of the capacity, and at 0."""
    rng = np.random.RandomState(31 + stacked)
    b, hkv, g, hd, c, kq, li = 4, 2, 4, 128, 128, 4, 1
    t, q = _inputs(rng, b, hkv, g, hd, c, nl=2 if stacked else None, kq=kq)
    wp = np.array([5, 30, c - kq, 0], np.int32)
    valid = np.zeros((b, c), bool)
    for i in range(b):
        valid[i, 2 : wp[i] + kq] = True  # history after 2 rows of padding + the K new rows
    kw = dict(layer=li) if stacked else {}
    got = TK.decode_attention_int8_multi(_tq(q), *(T(t[k]) for k in KEYS), T(valid), T(wp), **kw)
    assert got.shape == (b, kq, hkv * g, hd)
    with jax_mode(mode):
        ref = JK.decode_attention_int8_multi(jnp.asarray(q, jnp.bfloat16), *(jnp.asarray(t[k]) for k in KEYS),
                                             jnp.asarray(valid), jnp.asarray(wp), **kw)
    _ulp_close(got, ref)


@pytest.mark.parametrize("mode", ["xla", "pallas"])
@pytest.mark.parametrize("kq", [1, 5])
@pytest.mark.parametrize("stacked", [False, True])
def test_single_layer_stores_match_jax(mode, kq, stacked):
    """K17 (store_kv_rows, one row) and K18 (store_kv_rows_k, kq rows), into
    an unstacked cache or layer 1 of a 3-layer stack, in place: positions in
    a tile, straddling 32-row tiles, at a tile start and at C - kq;
    byte-identical to JAX, every other layer untouched."""
    rng = np.random.RandomState(41 + kq + 2 * stacked)
    b, hkv, c, hd, li = 4, 2, 128, 128, 1
    t, _ = _inputs(rng, b, hkv, 1, hd, c, nl=3 if stacked else None)
    new = dict(k8n=rng.randint(-127, 128, (b, hkv, kq, hd)).astype(np.int8), ksn=rng.rand(b, hkv, kq).astype(np.float32),
               v8n=rng.randint(-127, 128, (b, hkv, kq, hd)).astype(np.int8), vsn=rng.rand(b, hkv, kq).astype(np.float32))
    pos = np.array([3, 30, 64, c - kq], np.int32)
    kw = dict(layer=li) if stacked else {}
    cache = {k: T(t[k]).clone() for k in KEYS}
    fn_t, fn_j = (TK.store_kv_rows, JK.store_kv_rows) if kq == 1 else (TK.store_kv_rows_k, JK.store_kv_rows_k)
    out = fn_t(*cache.values(), *(T(new[k]) for k in new), T(pos), **kw)
    assert all(o is cache[k] for o, k in zip(out, KEYS))  # in place
    with jax_mode(mode):
        ref = fn_j(*(jnp.asarray(t[k]) for k in KEYS), *(jnp.asarray(new[k]) for k in new), jnp.asarray(pos),
                   **({"layer": jnp.int32(li)} if stacked else {}))
    for k, r in zip(KEYS, ref):
        np.testing.assert_array_equal(cache[k].numpy(), np.asarray(r), err_msg=k)
    if stacked:
        for k in KEYS:
            np.testing.assert_array_equal(cache[k][[0, 2]].numpy(), t[k][[0, 2]], err_msg=k)
