"""PyTorch port's training pieces vs the JAX package on the CPU (float32,
seeded numpy inputs): each loss and its gradient (`train/losses.py`), the
text stack's training forward `text_forward` with and without per-layer
checkpointing (hidden states, K/V and every gradient), and the optimizers
(AdamW, the hand-written Adafactor, the learning-rate schedules) against
optax over three updates.

Tolerances: 1e-5 relative to the reference's magnitude for values (float32
on both sides, only the order of sums differs); 1e-4 for gradients of the
text stack (sums over every position, ordered differently); optimizer
parameters after three updates within 1e-4 of the largest total update
(elementwise updates with the same formulas, but optax takes the bias
corrections in float32 and torch's AdamW in float64: ~3e-5 of an update)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from test_torch_common import close, tiny_params, torch_cfg
from padt_tpu.models import language as JL
from padt_tpu.train import losses as JLo
from padt_tpu.train import train_step as JS
from padt_tpu_torch.models import language as TL
from padt_tpu_torch.train import losses as TLo
from padt_tpu_torch.train import train_step as TS

T = lambda a: torch.tensor(np.asarray(a))


def _grads_match(jfn, tfn, arrays, tol=1e-5):
    """Value and gradient w.r.t. every float array, JAX vs the port."""
    idx = [i for i, a in enumerate(arrays) if a.dtype == np.float32]
    jv, jg = jax.value_and_grad(lambda *xs: jfn(*xs), argnums=tuple(idx))(*(jnp.asarray(a) for a in arrays))
    ts = [T(a).requires_grad_() if i in idx else T(a) for i, a in enumerate(arrays)]
    tv = tfn(*ts)
    tv.backward()
    close(tv, np.asarray(jv), tol)
    for i, g in zip(idx, jg):  # no grad on the port's side: a detached input (JAX gives zeros)
        close(ts[i].grad if ts[i].grad is not None else torch.zeros_like(ts[i]), np.asarray(g), tol)


def test_box_score_and_mask_losses_match_jax():
    r = np.random.RandomState(0)
    n = 6
    pred = (r.rand(n, 4) * 0.5 + 0.2).astype(np.float32)
    gt = np.sort(r.rand(n, 4).astype(np.float32).reshape(n, 2, 2), axis=1).transpose(0, 2, 1).reshape(n, 4)[:, [0, 2, 1, 3]]
    valid = np.array([1, 1, 0, 1, 0, 1], bool)
    score = r.randn(n, 1).astype(np.float32)
    _grads_match(lambda p, g, v: JLo.bbox_losses(p, g, v)["bbox_loss"],
                 lambda p, g, v: TLo.bbox_losses(p, g, v)["bbox_loss"], [pred, gt, valid])
    for key in ("iou_mean", "giou_mean", "giou"):
        close(TLo.bbox_losses(T(pred), T(gt), T(valid))[key], np.asarray(JLo.bbox_losses(pred, gt, valid)[key]))
    giou = np.asarray(JLo.bbox_losses(pred, gt, valid)["giou"])
    _grads_match(lambda s, g, v: JLo.score_loss(s, g, v), lambda s, g, v: TLo.score_loss(s, g, v), [score, giou, valid])

    logits = r.randn(n, 12, 16).astype(np.float32) * 3
    target = (r.rand(n, 12, 16) > 0.5).astype(np.float32)
    mask = np.zeros((n, 12, 16), np.float32)
    mask[:4, :10, :14] = 1.0  # two objects with an empty loss mask
    for name in ("dice_loss", "sigmoid_focal_loss"):
        _grads_match(getattr(JLo, name), getattr(TLo, name), [logits, target, mask])


@pytest.mark.parametrize("vp_mask", [True, False])
@pytest.mark.parametrize("pair", [True, False])
def test_sft_token_loss_matches_jax(vp_mask, pair):
    """Text and VRT targets, penalized slots (one row with every slot
    penalized: finite thanks to -1e30), padded completion positions."""
    r = np.random.RandomState(1)
    b, lc, v, m = 2, 9, 20, 7
    lt = r.randn(b, lc, v).astype(np.float32) * 2
    lv = r.randn(b, lc, m).astype(np.float32) * 2
    lv[1, :, 5:] = -1e30  # slots past num_merged
    tgt = r.randint(0, v, (b, lc))
    tgt[0, 2:5] = v + np.array([1, 3, 4])
    tgt[1, 0] = v + 2
    pen = r.rand(b, lc, m) > 0.6
    pen[1, 0, :] = True
    comp = np.ones((b, lc), np.float32)
    comp[1, 6:] = 0

    def jfn(lt, lv, tgt, comp, pen):
        logits = (lt, lv) if pair else jnp.concatenate([lt, lv], -1)
        return JLo.sft_token_loss(logits, tgt, comp, pen, v, use_vp_mask=vp_mask).sum()

    def tfn(lt, lv, tgt, comp, pen):
        logits = (lt, lv) if pair else torch.cat([lt, lv], -1)
        return TLo.sft_token_loss(logits, tgt, comp, pen, v, use_vp_mask=vp_mask).sum()

    _grads_match(jfn, tfn, [lt, lv, tgt, comp, pen])


@pytest.mark.parametrize("remat", [False, True])
def test_text_forward_and_grads_match_jax(remat):
    """text_forward: hidden and K/V on valid rows, and the gradient of a
    loss on the valid rows w.r.t. the inputs and every layer leaf."""
    cfg, jp, tp = tiny_params(2)
    tcfg = torch_cfg(cfg).text
    r = np.random.RandomState(3)
    b, l = 3, 24
    embeds = r.randn(b, l, cfg.text.hidden_size).astype(np.float32)
    valid = np.ones((b, l), bool)
    valid[0, :7] = False
    valid[2, :1] = False
    pos = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    pos3 = np.broadcast_to(pos[None], (3, b, l)).copy()
    pos3[1, :, 5:9] += 2
    w = (r.randn(b, l, cfg.text.hidden_size) * valid[:, :, None]).astype(np.float32)

    def jloss(params, x):
        h, (ka, va) = JL.text_forward(params, cfg.text, x, jnp.asarray(pos3), jnp.asarray(valid), remat=remat)
        return jnp.sum(h * w), (h, ka, va)

    (jv, (jh, jk, jvv)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jp["text"], jnp.asarray(embeds))
    params = {k: (dict(v) if isinstance(v, dict) else v) for k, v in tp["text"].items()}
    leaves = [params["embed"], params["final_ln_w"], *params["layers"].values()]
    for t in leaves:
        t.requires_grad_()
    x = T(embeds).requires_grad_()
    th, (tk, tv) = TL.text_forward(params, tcfg, x, T(pos3), T(valid), remat=remat)
    (th * T(w)).sum().backward()
    close(th, np.asarray(jh), rows=valid)
    rows = valid[None].repeat(cfg.text.num_hidden_layers, 0)
    close(tk, np.asarray(jk), rows=rows)
    close(tv, np.asarray(jvv), rows=rows)
    close(x.grad, np.asarray(jgx), 1e-4)
    close(params["final_ln_w"].grad, np.asarray(jgp["final_ln_w"]), 1e-4)
    for k, g in jgp["layers"].items():
        close(params["layers"][k].grad, np.asarray(g), 1e-4)
    for t in leaves:
        t.grad = None
        t.requires_grad_(False)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _opt_tree(seed=0):
    """A factored leaf (two axes >= 128, stacked like the layer weights), an
    unfactored 2-D leaf, a vector, and a frozen subtree."""
    r = np.random.RandomState(seed)
    return {
        "text": {"w": r.randn(3, 128, 160).astype(np.float32) * 0.02,
                 "small": r.randn(96, 40).astype(np.float32) * 0.02,
                 "b": r.randn(40).astype(np.float32) * 0.02},
        "vision": {"w": r.randn(8, 8).astype(np.float32)},
    }


@pytest.mark.parametrize("name,wd,warmup,schedule", [
    ("adamw", 0.0, 0, "linear"), ("adamw", 0.1, 2, "cosine"), ("adafactor", 0.0, 1, "linear"), ("adafactor", 0.05, 0, "cosine"),
])
def test_optimizers_match_optax(name, wd, warmup, schedule):
    """Three updates (with gradient clipping active on the first) of the
    port's optimizer vs the JAX package's make_optimizer, frozen vision
    leaves masked: parameters, and which leaves hold state."""
    tree = _opt_tree()
    kw = dict(learning_rate=1e-2, weight_decay=wd, max_grad_norm=1.0, warmup_steps=warmup, total_steps=6,
              schedule=schedule, optimizer=name)
    jopt = JS.make_optimizer(frozen_mask=JS.vision_frozen_mask, **kw)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    tparams = {g: {k: torch.tensor(v) for k, v in d.items()} for g, d in tree.items()}
    topt = TS.make_optimizer(tparams, frozen_mask=TS.vision_frozen_mask, **kw)
    assert [n for n, _ in topt.leaves] == ["text.w", "text.small", "text.b"]
    assert not tparams["vision"]["w"].requires_grad
    r = np.random.RandomState(9)
    for step in range(3):
        grads = jax.tree.map(lambda a: (r.randn(*a.shape) * (3.0 if step == 0 else 0.05)).astype(np.float32), tree)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for (_, p), g in zip(topt.leaves, (grads["text"]["w"], grads["text"]["small"], grads["text"]["b"])):
            p.grad = torch.tensor(g)
        gn = topt.step()
        np.testing.assert_allclose(float(gn), float(optax.global_norm(grads["text"])), rtol=1e-5)
    for k in ("w", "small", "b"):
        a, b = tparams["text"][k].detach().numpy(), np.asarray(jparams["text"][k])
        moved = np.abs(b - tree["text"][k]).max()
        assert moved > 1e-3 and np.abs(a - b).max() <= 1e-4 * moved, (k, np.abs(a - b).max(), moved)
    np.testing.assert_array_equal(tparams["vision"]["w"].numpy(), tree["vision"]["w"])
    if name == "adafactor":
        st = topt.inner.state
        w, small = tparams["text"]["w"], tparams["text"]["small"]
        assert set(st[w]) == {"step", "v_row", "v_col"} and st[w]["v_row"].shape == (3, 128)
        assert set(st[small]) == {"step", "v"}
    assert all(p is not tparams["vision"]["w"] for p in topt.inner.state)


def test_lr_schedule_matches_optax():
    for warmup, schedule in ((0, "linear"), (3, "linear"), (0, "cosine"), (4, "cosine")):
        if schedule == "linear" and warmup:
            ref = optax.join_schedules([optax.linear_schedule(0.0, 1e-3, warmup), optax.linear_schedule(1e-3, 0.0, 7)], [warmup])
        elif schedule == "linear":
            ref = optax.linear_schedule(1e-3, 0.0, 10)
        else:
            ref = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup, 10)
        ours = TS.lr_schedule(1e-3, warmup, 10, schedule)
        for c in range(12):
            np.testing.assert_allclose(ours(c), float(ref(c)), rtol=1e-6, atol=1e-12, err_msg=(warmup, schedule, c))
    assert TS.lr_schedule(5e-4)(7) == 5e-4
