"""PyTorch port greedy `generate` vs `padt_tpu.models.padt.generate` on the
CPU (padt_tiny, float32): tokens and counts exactly equal, hidden states
within 1e-4 (relative to their magnitude: float32 on both sides, summed in
another order), with an EOS that one row hits early and then every row."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_common import close, jax_batch, seeded_image, tiny_params, tiny_processor, torch_batch, torch_cfg
from padt_tpu.models import padt as JP
from padt_tpu_torch.convert.from_jax import params_from_numpy
from padt_tpu_torch.models import padt as TP

STEPS = 12


def test_greedy_generate_is_token_exact():
    cfg, jp, _ = tiny_params(0)
    # larger text-layer weights than the 0.02 init, so the tiny model emits
    # varied tokens instead of one token repeated
    jp["text"]["layers"] = jax.tree.map(lambda x: x * 5.0 if x.ndim == 3 else x, jp["text"]["layers"])
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    proc = tiny_processor(cfg)
    imgs = [seeded_image((1, 8, 12), 1, u8=False), seeded_image((1, 16, 16), 2, u8=False)]
    batch = proc.build_batch(['find "x"', 'where is "the cat"'], imgs, patch_bucket=cfg.max_image_patches)
    jb, tb = jax_batch(batch.data), torch_batch(batch.data)
    deltas = batch.rope_deltas

    free = np.asarray(JP.generate(jp, cfg, jb, STEPS, jnp.asarray(deltas), eos_token_id=-1).tokens)
    # an EOS both rows emit, first at different steps: one row finishes
    # early and keeps emitting pad; once both have, the loop stops early
    first = [{int(t): i for i, t in reversed(list(enumerate(row)))} for row in free]
    common = sorted(set(first[0]) & set(first[1]), key=lambda t: max(first[0][t], first[1][t]))
    assert common, free
    eos = common[0]
    assert first[0][eos] != first[1][eos] and max(first[0][eos], first[1][eos]) < STEPS - 1

    jo = JP.generate(jp, cfg, jb, STEPS, jnp.asarray(deltas), eos_token_id=eos)
    to = TP.generate(tp, torch_cfg(cfg), tb, STEPS, torch.as_tensor(deltas), eos_token_id=eos)
    np.testing.assert_array_equal(to.tokens.numpy(), np.asarray(jo.tokens))
    np.testing.assert_array_equal(to.num_generated.numpy(), np.asarray(jo.num_generated))
    assert sorted(to.num_generated.tolist()) == sorted(first[r][eos] + 1 for r in range(2))
    close(to.hidden, np.asarray(jo.hidden), tol=1e-4)
    assert torch.all(to.hidden[:, int(to.num_generated.max()) :] == 0)


def test_int8_generate_is_token_exact():
    """kv_cache_dtype="int8" (capacity rounded up to 128, H4 decode
    attention and H6 row stores through their twins) on packed weights:
    tokens and counts equal to JAX's int8 generate, hidden states within
    1e-3 (an int8 value may differ by one quantum at a rounding boundary)."""
    cfg, jp, _ = tiny_params(0)
    jp["text"]["layers"] = jax.tree.map(lambda x: x * 5.0 if x.ndim == 3 else x, jp["text"]["layers"])
    tp = TP.pack_inference_params(params_from_numpy(jax.tree.map(np.asarray, jp)))
    proc = tiny_processor(cfg)
    imgs = [seeded_image((1, 8, 12), 3, u8=False), seeded_image((1, 12, 16), 4, u8=False)]
    batch = proc.build_batch(['find "x"', 'where is "the dog"'], imgs, patch_bucket=cfg.max_image_patches)
    jb, tb = jax_batch(batch.data), torch_batch(batch.data)
    deltas = batch.rope_deltas
    jo = JP.generate(jp, cfg, jb, STEPS, jnp.asarray(deltas), eos_token_id=-1, kv_cache_dtype="int8")
    to = TP.generate(tp, torch_cfg(cfg), tb, STEPS, torch.as_tensor(deltas), eos_token_id=-1, kv_cache_dtype="int8")
    np.testing.assert_array_equal(to.tokens.numpy(), np.asarray(jo.tokens))
    assert len(set(to.tokens.flatten().tolist())) > 3
    np.testing.assert_array_equal(to.num_generated.numpy(), np.asarray(jo.num_generated))
    close(to.hidden, np.asarray(jo.hidden), tol=1e-3)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_quantized_generate_is_token_exact(kv):
    """int8 text-layer weights, each side quantized by its own
    `quantize_params` (every text-layer product through H7's twin on the
    port's side), unpacked with the bf16 KV cache and packed (the serve
    layout) with the int8 one: tokens and counts equal to JAX's, hidden
    states within 1e-3 (an int8 KV value may differ by one quantum at a
    rounding boundary)."""
    cfg, jp, _ = tiny_params(0)
    jp["text"]["layers"] = jax.tree.map(lambda x: x * 5.0 if x.ndim == 3 else x, jp["text"]["layers"])
    tp = TP.quantize_params(params_from_numpy(jax.tree.map(np.asarray, jp)))
    jq = JP.quantize_params(jp)
    if kv == "int8":
        jq, tp = JP.pack_inference_params(jq), TP.pack_inference_params(tp)
    assert ("qkv_w_q" in tp["text"]["layers"]) == (kv == "int8") and "o_w" not in tp["text"]["layers"]
    proc = tiny_processor(cfg)
    imgs = [seeded_image((1, 8, 12), 5, u8=False), seeded_image((1, 12, 16), 6, u8=False)]
    batch = proc.build_batch(['find "x"', 'where is "the bird"'], imgs, patch_bucket=cfg.max_image_patches)
    jb, tb = jax_batch(batch.data), torch_batch(batch.data)
    deltas = batch.rope_deltas
    jo = JP.generate(jq, cfg, jb, STEPS, jnp.asarray(deltas), eos_token_id=-1, kv_cache_dtype=kv)
    to = TP.generate(tp, torch_cfg(cfg), tb, STEPS, torch.as_tensor(deltas), eos_token_id=-1, kv_cache_dtype=kv)
    np.testing.assert_array_equal(to.tokens.numpy(), np.asarray(jo.tokens))
    assert len(set(to.tokens.flatten().tolist())) > 3
    np.testing.assert_array_equal(to.num_generated.numpy(), np.asarray(jo.num_generated))
    close(to.hidden, np.asarray(jo.hidden), tol=1e-3)


def test_sample_token_greedy_and_seeded_sampling():
    r = np.random.RandomState(0)
    logits = torch.tensor(r.randn(3, 50).astype(np.float32) * 3)
    greedy = TP.sample_token(logits)
    assert torch.equal(greedy, logits.argmax(-1))
    # top-k 1 and a tiny nucleus keep only the argmax
    g = torch.Generator().manual_seed(0)
    assert torch.equal(TP.sample_token(logits, g, do_sample=True, top_k=1), greedy)
    assert torch.equal(TP.sample_token(logits, g, do_sample=True, top_p=1e-6), greedy)
    # sampling is reproducible from the generator's seed and stays in the top-k set
    draw = lambda: TP.sample_token(logits, torch.Generator().manual_seed(7), do_sample=True, temperature=2.0, top_k=5)
    a, b = draw(), draw()
    assert torch.equal(a, b)
    top5 = torch.topk(logits, 5, dim=-1).indices
    assert all(int(a[i]) in top5[i].tolist() for i in range(3))
