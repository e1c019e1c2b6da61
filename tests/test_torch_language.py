"""PyTorch port text stack vs `padt_tpu.models.language` on the CPU
(padt_tiny, float32, tolerance 1e-5 relative to the reference's magnitude):
prefill then three decode steps, hidden states on valid rows and the KV
cache on live slots, with the bf16 and the int8 cache."""

import numpy as np

import jax.numpy as jnp
import torch

from test_torch_common import close, tiny_params, torch_cfg
from padt_tpu.models import language as JL
from padt_tpu.models import padt as JP
from padt_tpu_torch.models import language as TL
from padt_tpu_torch.models import padt as TP

T = lambda a: torch.tensor(np.asarray(a))


def _inputs(cfg, b=3, l=24, seed=0):
    r = np.random.RandomState(seed)
    embeds = r.randn(b, l, cfg.text.hidden_size).astype(np.float32)
    valid = np.ones((b, l), bool)
    valid[0, :7] = False  # left padding
    valid[2, :1] = False
    pos = np.cumsum(valid, axis=1).astype(np.int32) - 1
    pos3 = np.broadcast_to(np.maximum(pos, 0)[None], (3, b, l)).copy()
    pos3[1, :, 5:9] += 2  # an image-like span: h/w streams differ from t
    return embeds, valid, pos3


def test_prefill_and_decode_match_jax():
    cfg, jp, tp = tiny_params(1)
    tc, ttc = cfg.text, torch_cfg(cfg).text
    embeds, valid, pos3 = _inputs(cfg)
    b, l = valid.shape
    cap = l + 3
    jh, jcache = JL.prefill(jp["text"], tc, jnp.asarray(embeds), jnp.asarray(pos3), jnp.asarray(valid), cap)
    th, tcache = TL.prefill(tp["text"], ttc, T(embeds), T(pos3), T(valid), cap)
    close(th, np.asarray(jh), rows=valid)
    close(tcache.k[:, :, :l].permute(1, 2, 0, 3, 4), np.asarray(jcache.k)[:, :, :l].transpose(1, 2, 0, 3, 4), rows=valid)
    close(tcache.v[:, :, :l].permute(1, 2, 0, 3, 4), np.asarray(jcache.v)[:, :, :l].transpose(1, 2, 0, 3, 4), rows=valid)

    r = np.random.RandomState(5)
    last = pos3[:, :, -1]
    for step in range(3):
        emb = r.randn(b, 1, tc.hidden_size).astype(np.float32)
        p = (last + 1 + step)[:, :, None].astype(np.int32)
        jh, jcache = JL.decode_step(jp["text"], tc, jnp.asarray(emb), jnp.asarray(p), jcache)
        th, tcache = TL.decode_step(tp["text"], ttc, T(emb), T(p), tcache)
        close(th, np.asarray(jh))
        assert tcache.length == int(jcache.length) == l + step + 1
        np.testing.assert_array_equal(tcache.valid.numpy(), np.asarray(jcache.valid))
    live = np.asarray(jcache.valid)
    close(tcache.k.permute(1, 2, 0, 3, 4), np.asarray(jcache.k).transpose(1, 2, 0, 3, 4), rows=live)
    close(tcache.v.permute(1, 2, 0, 3, 4), np.asarray(jcache.v).transpose(1, 2, 0, 3, 4), rows=live)


def test_prefill_batch_chunk_is_exact_and_int8_is_the_next_slice():
    """batch_chunk is exact, and the int8 KV cache (the serve path) matches
    JAX: prefill quantizes the same live rows (an int8 value may differ by
    one quantum at a rounding boundary), then three int8 decode steps on
    packed weights give the same hidden states at 1e-5."""
    cfg, jp, tp = tiny_params(1)
    ttc = torch_cfg(cfg).text
    embeds, valid, pos3 = _inputs(cfg, b=4)
    args = (tp["text"], ttc, T(embeds), T(pos3), T(valid), 30)
    h1, c1 = TL.prefill(*args)
    h2, c2 = TL.prefill(*args, batch_chunk=2)
    close(h2, h1.numpy())
    close(c2.k, c1.k.numpy())

    b, l = valid.shape
    cap = 128
    jpt = JP.pack_inference_params(jp)["text"]
    tpt = TP.pack_inference_params(tp)["text"]
    jh, jc = JL.prefill(jpt, cfg.text, jnp.asarray(embeds), jnp.asarray(pos3), jnp.asarray(valid), cap, kv_dtype="int8")
    th, tc = TL.prefill(tpt, ttc, T(embeds), T(pos3), T(valid), cap, kv_dtype="int8", batch_chunk=2)
    close(th, np.asarray(jh), rows=valid)
    live = np.zeros((b, cap), bool)
    live[:, :l] = valid
    for t8, ts, j8, js in ((tc.k, tc.k_scale, jc.k, jc.k_scale), (tc.v, tc.v_scale, jc.v, jc.v_scale)):
        d = np.abs(t8.numpy().astype(np.int32) - np.asarray(j8).astype(np.int32)).transpose(1, 3, 0, 2, 4)[live]
        assert d.max() <= 1 and (d > 0).mean() < 1e-3
        close(ts.numpy().transpose(1, 3, 0, 2)[live], np.asarray(js).transpose(1, 3, 0, 2)[live])
    r = np.random.RandomState(5)
    for step in range(3):
        emb = r.randn(b, 1, cfg.text.hidden_size).astype(np.float32)
        p = (pos3[:, :, -1] + 1 + step)[:, :, None].astype(np.int32)
        jh, jc = JL.decode_step(jpt, cfg.text, jnp.asarray(emb), jnp.asarray(p), jc)
        th, tc = TL.decode_step(tpt, ttc, T(emb), T(p), tc)
        close(th, np.asarray(jh))
        assert tc.length == int(jc.length) == l + step + 1
        np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    new = np.asarray(jc.valid) & ~live
    d = np.abs(tc.k.numpy().astype(np.int32) - np.asarray(jc.k).astype(np.int32)).transpose(1, 3, 0, 2, 4)[new]
    assert d.size and d.max() <= 1
