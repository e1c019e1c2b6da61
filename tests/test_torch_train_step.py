"""PyTorch port's `padt_loss` vs `padt_tpu.train.train_step.padt_loss` on the
CPU (padt_tiny, float32, the same seeded batch and bridged weights): the
loss, every metric and the gradient of every leaf, with the tower frozen
and unfrozen, warm-up on and off, and the int8 feature cache.

Tolerances: loss and metrics 1e-5 relative (float32 on both sides, only the
order of sums differs); each gradient leaf within 1e-4 of its largest
magnitude (a gradient is a sum over the whole batch of products that each
side orders differently, so it keeps about one decimal digit less than the
values it is made of). With the int8 feature cache a feature may sit one
quantum apart where the two towers' float32 outputs straddle a rounding
tie, which moves the loss by ~1e-6 and a gradient by up to ~3e-4 of its
largest magnitude: there the gradients are held within 2e-3."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_common import tiny_params, torch_cfg
from padt_tpu.models import padt as JP
from padt_tpu.train import train_step as JS
from padt_tpu_torch.models import padt as TP
from padt_tpu_torch.train import train_step as TS

GRAD_TOL = 1e-4
LP, LC = 96, 32


@pytest.fixture(scope="module")
def setup():
    from bench_train import _build_batch

    cfg, jp, tp = tiny_params(0)
    cfg = cfg.replace(max_image_patches=256)
    batch, canvas_hw = _build_batch(cfg, 2, (1, 16, 16), LP, LC)
    host = {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16 else np.asarray(v) for k, v in batch.items()}
    # one object whose picks carry a VRT penalty, one invalid object past the batch
    host["vrt_penalty_mask"] = host["vrt_penalty_mask"].copy()
    host["vrt_penalty_mask"][0, 6:11, 10:20] = True
    return cfg, jp, tp, host, canvas_hw


# JAX's reference, compiled once per loss configuration (eager JAX compiles
# every primitive on its own and takes several times longer)
_jax_value_and_grad = jax.jit(jax.value_and_grad(JS.padt_loss, has_aux=True), static_argnums=(1, 3, 4, 5))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _torch_loss_and_grads(tp, tcfg, batch, canvas_hw, lcfg, warmup, frozen):
    params = {k: (dict(v) if isinstance(v, dict) else v) for k, v in tp.items()}
    leaves = _flat(params)
    for name, t in leaves.items():
        t.requires_grad_(not (frozen and name.startswith("vision/")))
    loss, metrics = TS.padt_loss(params, tcfg, batch, LP, canvas_hw, lcfg, warmup)
    loss.backward()
    grads = {k: (t.grad.clone() if t.grad is not None else torch.zeros_like(t)) for k, t in leaves.items()}
    for t in leaves.values():
        t.grad = None
        t.requires_grad_(False)
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _compare(jl, jm, jg, tl, tm, tg, grad_tol=GRAD_TOL):
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    jf = {k: np.asarray(v) for k, v in _flat(jg).items()}
    assert set(jf) == set(tg)
    n_nonzero = 0
    for k, g in jf.items():
        t = tg[k].numpy()
        assert t.shape == g.shape, k
        err = np.abs(t - g).max()
        assert err <= grad_tol * (np.abs(g).max() + 1e-6), (k, err, np.abs(g).max())
        n_nonzero += bool(np.abs(g).max() > 0)
    return n_nonzero


@pytest.mark.parametrize("frozen,warmup", [(True, False), (True, True), (False, False)])
def test_padt_loss_and_grads_match_jax(setup, frozen, warmup):
    cfg, jp, tp, host, canvas_hw = setup
    lcfg_j = JS.LossConfig(freeze_vision=frozen)
    lcfg_t = TS.LossConfig(freeze_vision=frozen)
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    (jl, jm), jg = _jax_value_and_grad(jp, cfg, jbatch, LP, canvas_hw, lcfg_j, jnp.asarray(warmup))
    tbatch = {k: torch.as_tensor(v) for k, v in host.items()}
    tl, tm, tg = _torch_loss_and_grads(tp, torch_cfg(cfg), tbatch, canvas_hw, lcfg_t, warmup, frozen)
    n = _compare(jl, jm, jg, tl, tm, tg)
    vis = [k for k in tg if k.startswith("vision/")]
    if frozen:  # no graph through the tower: zero in JAX (stop_gradient), never touched here
        assert all(float(tg[k].abs().max()) == 0.0 for k in vis)
    else:
        assert any(float(tg[k].abs().max()) > 0.0 for k in vis)
    assert n > 40


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_cached_vision_features_match_jax(setup, quant):
    """vision_features + the cached batch: the same cache keys and values as
    JAX's, and padt_loss on the cached batch with the same loss, metrics and
    gradients."""
    cfg, jp, tp, host, canvas_hw = setup
    tcfg = torch_cfg(cfg)
    vis = {k: host[k] for k in JP._VISION_BATCH_KEYS if k in host}
    jf = jax.jit(lambda p, b: JP.vision_features(p, cfg, b, quant=quant))(jp, {k: jnp.asarray(v) for k, v in vis.items()})
    tf = TP.vision_features(tp, tcfg, {k: torch.as_tensor(v) for k, v in vis.items()}, quant=quant)
    assert set(tf) == set(jf) == set(TP.vision_cache_keys(quant))
    for k in jf:
        a, b = tf[k].numpy(), np.asarray(jf[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype == np.int8:  # one quantum at a rounding tie
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1, k
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max(), err_msg=k)
    cached = {k: v for k, v in host.items() if k not in JP._VISION_ONLY_KEYS}
    lcfg = dict(freeze_vision=True)
    jb = dict({k: jnp.asarray(v) for k, v in cached.items()}, **jf)
    (jl, jm), jg = _jax_value_and_grad(jp, cfg, jb, LP, canvas_hw, JS.LossConfig(**lcfg), jnp.asarray(False))
    tb = dict({k: torch.as_tensor(v) for k, v in cached.items()}, **tf)
    tl, tm, tg = _torch_loss_and_grads(tp, tcfg, tb, canvas_hw, TS.LossConfig(**lcfg), False, True)
    _compare(jl, jm, jg, tl, tm, tg, grad_tol=GRAD_TOL if quant == "none" else 2e-3)
    with pytest.raises(ValueError, match="freeze_vision"):
        TS.padt_loss(tp, tcfg, tb, LP, canvas_hw, TS.LossConfig(freeze_vision=False), False)


def test_train_step_launch_plan(setup, monkeypatch):
    """The kernel calls one train step makes, counted at the wrappers on the
    CPU: per text layer H2 twice (forward and checkpoint recompute), H1
    three times (forward, recompute, VJP), H8 and H9 once; the frozen tower
    H1 once per block, H2 per full block, H3 per windowed block; the
    decoder's six rotary projections H1 forward and VJP. chip_smoke asserts
    these counts on the card."""
    from padt_tpu_torch.ops import attention as A
    from padt_tpu_torch.ops import cuda_attention as C
    from padt_tpu_torch.ops import cuda_flash_bwd as FB

    cfg, jp, tp, host, canvas_hw = setup
    tcfg = torch_cfg(cfg)
    calls = {}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrap(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, wrap)

    for mod in (A, C):
        for name in ("rope_qk", "segment_flash_fwd", "window_slot_attn"):
            if hasattr(mod, name):
                counted(mod, name)
    counted(A, "flash_bwd_dq")
    counted(A, "flash_bwd_dkv")
    _torch_loss_and_grads(tp, tcfg, {k: torch.as_tensor(v) for k, v in host.items()}, canvas_hw,
                          TS.LossConfig(freeze_vision=True), False, True)
    assert calls == TS.train_step_launches(tcfg, slot_layout="pack_index" in host), calls
    assert FB.launch_counts == {"flash_bwd_dq": 0, "flash_bwd_dkv": 0}  # the CPU runs the twins
