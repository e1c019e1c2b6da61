"""The int8 x int8 score decode (`quantize_q`, PADT_DECODE_QI8) of the port vs
the JAX package on the CPU, on the same seeded numpy inputs.

- The op: the row quantization and the int32 score matrix exactly equal to
  JAX's; the output against the JAX plain fresh branch and the store-then-
  attend `_decode_attention_int8_xla(quantize_q=True)` oracle, and against
  the Pallas kernels (`_decode_attention_int8_pallas_stacked_fresh` and its
  batch-blocked form) in TPU interpret mode: within one bf16 ulp of the
  largest output magnitude (only the order of fp32 sums differs).
- The configuration: with `_QI8_DEFAULT` set on both sides (the module flag
  that PADT_DECODE_QI8=1 sets at import), a 64-step int8 `generate` and a
  `ServeEngine` run are token-exact against JAX on padt_tiny (float32), the
  hidden states within the JAX gate's 0.08 of the bf16-cache generation and
  within 1e-3 of JAX's QI8 run (an int8 value may differ by one quantum at a
  rounding boundary).
- The refusals of `test_qi8_unsupported_paths_fail_loudly`, and a QI8 serve
  engine with speculative decoding or shared prefixes raises as JAX's does.

Flipping the flag changes what JAX traces, so each QI8 test clears JAX's
caches before and after it."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_common import close, jax_batch, jax_mode, port_image, seeded_image, tiny_params, tiny_processor, torch_batch, torch_cfg
from test_torch_serve import _batches, _engines, _params, _requests, _same_completions
from padt_tpu.models import padt as JP
from padt_tpu.ops import kv_cache as JK
from padt_tpu_torch.convert.from_jax import params_from_numpy
from padt_tpu_torch.models import padt as TP
from padt_tpu_torch.ops import cuda_kv
from padt_tpu_torch.ops import kv_cache as TK

T = lambda a: torch.as_tensor(np.array(a))
KEYS = ("k8", "ks", "v8", "vs")
FRESH = ("k8n", "ksn", "v8n", "vsn")


@pytest.fixture
def qi8(monkeypatch):
    """PADT_DECODE_QI8 on both sides, with JAX's traces of the other setting dropped."""
    jax.clear_caches()
    monkeypatch.setattr(JK, "_QI8_DEFAULT", True)
    monkeypatch.setattr(TK, "_QI8_DEFAULT", True)
    yield
    jax.clear_caches()


def _ulp_close(got, ref):
    a, r = got.float().numpy(), np.asarray(ref, np.float32)
    ulp = 2.0 ** (math.floor(math.log2(float(np.abs(r).max()))) - 7)
    assert np.abs(a - r).max() <= ulp, (float(np.abs(a - r).max()), ulp)


def _fresh_case(seed, nl=3, b=8, hkv=2, g=8, hd=128, c=256):
    rng = np.random.RandomState(seed)
    i8 = lambda *s: rng.randint(-127, 128, s).astype(np.int8)
    sc = lambda *s: rng.lognormal(-4, 0.5, s).astype(np.float32)
    t = dict(k8=i8(nl, b, hkv, c, hd), ks=sc(nl, b, hkv, c), v8=i8(nl, b, hkv, c, hd), vs=sc(nl, b, hkv, c),
             k8n=i8(b, hkv, 1, hd), ksn=sc(b, hkv, 1), v8n=i8(b, hkv, 1, hd), vsn=sc(b, hkv, 1))
    q = np.array(jnp.asarray(rng.randn(b, 1, hkv * g, hd) * 0.5, jnp.bfloat16).astype(jnp.float32))
    q[0, 0, :g] = 0.0  # an all-zero q row: scale 1e-8 / 127, q8 = 0
    valid = np.ones((b, c), bool)
    valid[0, :11] = False
    valid[:, c // 2 :] = False  # the current position is c // 2
    return t, q, valid


def test_qi8_row_quantization_and_int32_scores_are_exact():
    t, q, _ = _fresh_case(1)
    b, _, h, hd = q.shape
    qg = q.reshape(b, 2, h // 2, hd)
    q8, qs = cuda_kv.quantize_q_rows_plain(T(qg).to(torch.bfloat16))
    jq8, jqs = JK.quantize_kv(jnp.asarray(qg, jnp.bfloat16))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8, np.float32))
    np.testing.assert_array_equal(qs.numpy(), np.asarray(jqs))
    dots = torch.einsum("bkgd,bkcd->bkgc", q8, T(t["k8"][1]).float())
    jdots = jnp.einsum("bkgd,bkcd->bkgc", jq8.astype(jnp.int32), jnp.asarray(t["k8"][1]).astype(jnp.int32))
    np.testing.assert_array_equal(dots.numpy(), np.asarray(jdots, np.float32))  # |dots| < 2^24: fp32 is exact


@pytest.mark.parametrize("mode", ["xla", "pallas"])
def test_qi8_decode_matches_jax(mode):
    """Layer 1 with the current token as the fresh column: the JAX fresh
    branch ("xla", also held against the store-then-attend oracle), or both
    Pallas fresh kernels in interpret mode ("pallas")."""
    t, q, valid = _fresh_case(2)
    nl, b, hkv, c, hd = t["k8"].shape
    li, pos = 1, c // 2
    got = TK.decode_attention_int8(T(q).to(torch.bfloat16), *(T(t[k]) for k in KEYS), T(valid), layer=li,
                                   fresh_kv=tuple(T(t[k]) for k in FRESH), quantize_q=True)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    jq, jc, jf = jnp.asarray(q, jnp.bfloat16), [jnp.asarray(t[k]) for k in KEYS], tuple(jnp.asarray(t[k]) for k in FRESH)
    if mode == "xla":
        with jax_mode("xla"):
            ref = JK.decode_attention_int8(jq, *jc, jnp.asarray(valid), layer=li, fresh_kv=jf, quantize_q=True)
        _ulp_close(got, ref)
        upd = {k: t[k][li].copy() for k in KEYS}
        for k, kn in zip(KEYS, FRESH):
            upd[k][:, :, pos] = t[kn][:, :, 0]
        valid_u = valid.copy()
        valid_u[:, pos] = True
        oracle = JK._decode_attention_int8_xla(jq.reshape(b, hkv, -1, hd), *(jnp.asarray(upd[k]) for k in KEYS),
                                               jnp.asarray(valid_u), quantize_q=True).reshape(q.shape)
        _ulp_close(got, oracle)
    else:
        qg = jq.reshape(b, hkv, -1, hd)
        args = (*jc, *jf, jnp.asarray(valid, jnp.int32), li)
        with jax_mode("pallas"):
            refs = (JK._decode_attention_int8_pallas_stacked_fresh(qg, *args, quantize_q=True),
                    JK._decode_attention_int8_pallas_stacked_fresh_bb(qg, *args, 4, quantize_q=True))
        for ref in refs:
            _ulp_close(got, np.asarray(ref, np.float32).reshape(q.shape))


def _spy_qi8(monkeypatch):
    """The quantize_q flag of every H4 twin call (the CPU's stand-in for
    the kernel)."""
    calls, plain = [], cuda_kv.int8_decode_attn_plain
    monkeypatch.setattr(cuda_kv, "int8_decode_attn_plain", lambda *a: calls.append(a[12]) or plain(*a))
    return calls


def test_qi8_generate_64_steps_token_exact(qi8, monkeypatch):
    """int8 `generate` under PADT_DECODE_QI8 on both sides (the flag reaches
    the decode step through quantize_q's default), 64 steps, on the inputs
    of JAX's test_qi8_generate_greedy_matches_bf16_full_generation: the
    port's tokens equal JAX's QI8 tokens and its bf16-cache tokens, the
    hidden states within 1e-3 of JAX's QI8 run and within the gate's 0.08 of
    the bf16-cache run."""
    from padt_tpu.config import padt_tiny
    from padt_tpu.preprocess.vision_process import ProcessedImage
    from padt_tpu.utils.mock_tokenizer import make_tiny_tokenizer
    from padt_tpu.vrt.processor import VisionTextProcessor

    cfg = padt_tiny()
    proc = VisionTextProcessor(make_tiny_tokenizer(cfg), cfg, seq_bucket=64, patch_bucket=128)
    proc.prepare(cfg.text.vocab_size)
    rng = np.random.RandomState(5)
    imgs = [ProcessedImage(rng.randn(96, 1176).astype(np.float32), (1, 8, 12)),
            ProcessedImage(rng.randn(64, 1176).astype(np.float32), (1, 8, 8))]
    jp = JP.init_padt_params(cfg, jax.random.PRNGKey(2), jnp.float32)
    tp = TP.pack_inference_params(params_from_numpy(jax.tree.map(np.asarray, jp)))
    batch = proc.build_batch(["find the dog", "describe"], imgs)
    jb = {k: jnp.asarray(v) for k, v in batch.data.items()}
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.data.items()}
    deltas, n = batch.rope_deltas, 64
    jref = JP.generate(jp, cfg, jb, n, jnp.asarray(deltas), eos_token_id=-1)  # the bf16 cache: the gate's reference
    jo = JP.generate(jp, cfg, jb, n, jnp.asarray(deltas), eos_token_id=-1, kv_cache_dtype="int8")
    calls = _spy_qi8(monkeypatch)
    to = TP.generate(tp, torch_cfg(cfg), tb, n, torch.as_tensor(deltas), eos_token_id=-1, kv_cache_dtype="int8")
    assert calls and all(calls) and len(calls) == cfg.text.num_hidden_layers * (n - 1)  # every decode step scored int8 x int8
    np.testing.assert_array_equal(to.tokens.numpy(), np.asarray(jo.tokens))
    np.testing.assert_array_equal(to.tokens.numpy(), np.asarray(jref.tokens))
    close(to.hidden, np.asarray(jo.hidden), tol=1e-3)
    h_ref = np.asarray(jref.hidden, np.float32)
    assert np.abs(to.hidden.numpy() - h_ref).max() / (np.abs(h_ref).max() + 1e-9) < 0.08


def test_qi8_serve_engine_token_exact(qi8, monkeypatch):
    """ServeEngine plain decode (4 requests through 3 slots, refills) under
    PADT_DECODE_QI8 on both sides: every completion equal to the JAX
    engine's, and the step counters agree."""
    cfg, jp, tp = _params()
    proc = tiny_processor(cfg)
    batches = _batches(cfg, proc, ["detect the cat", "find a dog", "locate the car", "what is here"], 3)
    kw = dict(n_slots=3, max_new_tokens=10, prompt_len=128, prefill_bucket=1, chunk_steps=3, collect_hidden=True, patch_bucket=128)
    jeng, teng = _engines(cfg, jp, tp, **kw)
    jreqs, treqs = _requests(batches, [6, 10, 4, 8])
    jres, jstats = jeng.run(jreqs)
    calls = _spy_qi8(monkeypatch)
    tres, tstats = teng.run(treqs)
    assert calls and all(calls)
    _same_completions(jres, tres)
    assert (tstats.generated_tokens, tstats.decode_steps) == (jstats.generated_tokens, jstats.decode_steps)


def test_qi8_unsupported_paths_fail_loudly(monkeypatch):
    """As JAX's test of the same name: quantize_q without fresh_kv, and the
    multi-query form with quantize_q given or from the PADT_DECODE_QI8
    default, raise NotImplementedError."""
    t, q, valid = _fresh_case(3, b=2)
    cache = [T(t[k]) for k in KEYS]
    tq = T(q).to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="quantize_q"):
        TK.decode_attention_int8(tq, *cache, T(valid), layer=0, quantize_q=True)
    qm = tq.expand(2, 2, *tq.shape[2:])
    wp = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="quantize_q"):
        TK.decode_attention_int8_multi(qm, *cache, T(valid), wp, layer=0, quantize_q=True)
    monkeypatch.setattr(TK, "_QI8_DEFAULT", True)
    with pytest.raises(NotImplementedError, match="quantize_q"):
        TK.decode_attention_int8_multi(qm, *cache, T(valid), wp, layer=0)


@pytest.mark.parametrize("kind", ["speculative", "share_prefix"])
def test_qi8_serve_refuses_multi_query_paths(qi8, kind):
    """Under PADT_DECODE_QI8 a speculative engine (K-token verify) and a
    shared-prefix admission (suffix pass) reach the multi-query attention,
    which refuses quantize_q: the run raises, as JAX's does."""
    from padt_tpu_torch.eval.harness import InferenceEngine
    from padt_tpu_torch.serve import ServeEngine

    cfg, _, tp = _params()
    tcfg = torch_cfg(cfg)
    img = port_image(seeded_image((1, 8, 12), 9, u8=False))
    eng = InferenceEngine(tp, tcfg, tiny_processor(tcfg), max_new_tokens=6, compact_pixels=False)
    prompts = ["find a dog", "find a cat"]
    with pytest.raises(NotImplementedError, match="quantize_q"):
        if kind == "share_prefix":
            eng.run_stream(prompts, [img, img], n_slots=2, prefill_bucket=1, patch_bucket=128, share_prefix=True)
        else:
            reqs, plen = eng.build_stream_requests(prompts, [img, img], patch_bucket=128, prompt_bucket=128)
            spec = ServeEngine(TP.pack_inference_params(tp), tcfg, n_slots=2, max_new_tokens=6, prompt_len=plen,
                               prefill_bucket=1, patch_bucket=128, speculative=4)
            spec.run(reqs)
