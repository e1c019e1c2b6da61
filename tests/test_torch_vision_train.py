"""The trained vision tower on the CPU: the port's differentiable vision
attention (`ops.attention.fused_vision_attention_qkv` and
`window_attention_qkv` under grad: H1 + H2 with its LSE forward, H8 + H9 and
H1 with the sin negated backward, here through their plain twins) against
`jax.grad` of the JAX package's counterparts, per-block remat of the tower
against no remat, and the launch plan of a train step with the tower
trained.

JAX runs as its own tests run it on the CPU: its plain branches
(PADT_PALLAS=0) at every case, and its custom VJPs (`vision_flash_attention_qkv`,
`vision_window_attention_qkv`: Pallas forward in interpret mode, XLA
backward) at one small case, s = 128 with 2 heads of 16. The cotangent is
zero on pad rows (seg -1): there the kernels give 0 and JAX's plain branch a
uniform average, which no valid row reads.

Tolerances: d(qkv) within 1e-5 of (1 + its largest magnitude), float32 on
both sides with only the order of sums differing (the port recomputes p
from the LSE, JAX from a softmax); against interpret-mode Pallas 1e-4 (its
forward pads each head to 128 lanes and sums in another order). Remat:
the same loss and gradients within 1e-6 (the recompute repeats the same
float32 operations)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_common import close, jax_mode, tiny_params, torch_cfg
from padt_tpu.ops import attention as JA
from padt_tpu_torch.ops import attention as TA

INTERPRET_TOL = 1e-4
REMAT_TOL = 1e-6


def _inputs(b, s, h, d, windowed, seed):
    """Seeded fused qkv (B, S, 3*H*d), rope tables (B, S, d) whose halves
    repeat, segment ids with pad rows, and a cotangent that is zero on them.
    Windowed: the 64-token slot layout, one window per slot (a full one, a
    part-filled one with tail pad, an empty one); else per-row segments of
    uneven length and a padded tail."""
    rng = np.random.RandomState(seed)
    qkv = (rng.randn(b, s, 3 * h * d) * 0.5).astype(np.float32)
    ang = rng.rand(b, s, d // 2).astype(np.float32) * 6.0
    cos, sin = np.cos(np.concatenate([ang, ang], -1)), np.sin(np.concatenate([ang, ang], -1))
    seg = np.full((b, s), -1, np.int32)
    if windowed:
        fill = [64, 40, 0, 17, 64, 9]
        for i in range(b):
            for slot in range(s // 64):
                n = fill[(slot + 2 * i) % len(fill)]
                seg[i, slot * 64 : slot * 64 + n] = 10 * i + slot
    else:
        cuts = [(0, 100, 220), (0, s - 32, s - 8)]
        for i in range(b):
            a, m, e = cuts[i % len(cuts)]
            seg[i, a:m], seg[i, m:e] = 0, 1
    g = (rng.randn(b, s, h * d) * (seg >= 0)[:, :, None]).astype(np.float32)
    return qkv, cos.astype(np.float32), sin.astype(np.float32), seg, g


def _port_dqkv(qkv, cos, sin, seg, g, h, windowed):
    x = torch.tensor(qkv, requires_grad=True)
    fn = TA.window_attention_qkv if windowed else TA.fused_vision_attention_qkv
    d = cos.shape[-1]
    out = fn(x, torch.tensor(cos), torch.tensor(sin), torch.tensor(seg), h, scale=d**-0.5, rope_dim=d)
    (out * torch.tensor(g)).sum().backward()
    return out.detach().numpy(), x.grad.numpy()


def _jax_dqkv(qkv, cos, sin, seg, g, h, windowed, mode):
    d = cos.shape[-1]
    b, s, _ = qkv.shape

    def loss(x):
        with jax_mode(mode):
            if windowed:
                o = JA.window_attention_qkv(x, jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(seg), h, scale=d**-0.5, rope_dim=d)
            else:
                o = JA.fused_vision_attention_qkv(x, jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(seg), h, scale=d**-0.5, rope_dim=d)
        if o.shape[-1] != h * d:  # Pallas pads each head to 128 lanes: narrow to the real ones
            o = o.reshape(b, s, h, -1)[..., :d].reshape(b, s, h * d)
        return (o * jnp.asarray(g)).sum(), o

    (_, out), dq = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(qkv))
    return np.asarray(out), np.asarray(dq)


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("b,s,h,d", [(2, 256, 4, 16), (1, 192, 2, 32)])
def test_vision_qkv_grad_matches_jax_plain(windowed, b, s, h, d):
    qkv, cos, sin, seg, g = _inputs(b, s, h, d, windowed, seed=s + h)
    out, dq = _port_dqkv(qkv, cos, sin, seg, g, h, windowed)
    jout, jdq = _jax_dqkv(qkv, cos, sin, seg, g, h, windowed, "xla")
    valid = seg >= 0
    close(out[valid], jout[valid])
    close(dq, jdq)
    assert not dq[~valid].any()  # a pad row is neither a query nor a key of any valid row


@pytest.mark.parametrize("windowed", [False, True])
def test_vision_qkv_grad_matches_jax_custom_vjp(windowed):
    """JAX's custom VJP with its Pallas forward in interpret mode, s = 128."""
    b, s, h, d = 1, 128, 2, 16
    qkv, cos, sin, seg, g = _inputs(b, s, h, d, windowed, seed=7)
    out, dq = _port_dqkv(qkv, cos, sin, seg, g, h, windowed)
    jout, jdq = _jax_dqkv(qkv, cos, sin, seg, g, h, windowed, "pallas")
    valid = seg >= 0
    close(out[valid], jout[valid], tol=INTERPRET_TOL)
    close(dq, jdq, tol=INTERPRET_TOL)


def _count_calls(monkeypatch, calls, mod, *names):
    """Count each call of mod.<name> into calls[name]."""
    for name in names:
        fn = getattr(mod, name)

        def wrap(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, wrap)


def _tower_inputs(cfg, seed):
    from padt_tpu_torch.models.vision_geom import vision_geometry

    grids = [(1, 8, 12), (1, 16, 16)]
    s = cfg.max_image_patches
    geo = vision_geometry(grids, s, window_slots=True)
    assert geo.pack_index is not None
    pix = np.random.RandomState(seed).randn(len(grids), s, cfg.vision.patch_input_dim).astype(np.float32)
    T = lambda a: torch.as_tensor(np.asarray(a))
    return [T(a) for a in (pix, geo.window_index, geo.inv_window_index, geo.seg_win, geo.seg_full, geo.hpos, geo.wpos)], T(geo.pack_index), geo


def test_vision_remat_matches_no_remat(monkeypatch):
    """vision_forward(remat=True) against remat=False with the tower
    trained: the same outputs, loss and every leaf's gradient; the
    checkpoints' recompute runs each block's H1 and H2 a second time."""
    from padt_tpu_torch.models.vision import vision_forward

    cfg, _, tp = tiny_params(0)
    vc = torch_cfg(cfg).vision
    args, pack, geo = _tower_inputs(cfg, seed=5)
    w = torch.randn(args[0].shape[0], cfg.max_image_patches, vc.hidden_size, generator=torch.Generator().manual_seed(1))
    rows = torch.as_tensor(np.arange(cfg.max_image_patches)[None, :] < np.asarray(geo.num_patches)[:, None])
    calls = {}
    _count_calls(monkeypatch, calls, TA, "rope_qk", "segment_flash_fwd", "window_slot_attn")

    def run(remat):
        params = {k: {kk: vv.clone().requires_grad_(True) for kk, vv in v.items()} if k == "blocks" else v
                  for k, v in tp["vision"].items()}
        calls.clear()
        merged, high, _ = vision_forward(params, vc, *args, remat=remat, pack_index=pack)
        loss = merged.square().sum() + (high * w * rows[:, :, None]).sum()
        loss.backward()
        return loss.item(), {k: v.grad for k, v in params["blocks"].items()}, dict(calls)

    l0, g0, c0 = run(False)
    l1, g1, c1 = run(True)
    np.testing.assert_allclose(l1, l0, rtol=REMAT_TOL)
    for k in g0:
        close(g1[k], g0[k].numpy(), tol=REMAT_TOL)
    depth = vc.depth
    assert c0 == {"rope_qk": 2 * depth, "segment_flash_fwd": depth}, c0  # forward and VJP; no H3 under grad
    assert c1 == {"rope_qk": 3 * depth, "segment_flash_fwd": 2 * depth}, c1  # and the recompute


def test_unfrozen_train_step_launch_plan(monkeypatch):
    """The kernel calls of one train step with the tower trained, counted at
    the wrappers on the CPU, against `train_step_launches(freeze_vision=
    False)`: every tower block as a text layer (H1 forward, recompute and
    VJP; H2 forward and recompute; H8 and H9), no H3. chip_smoke asserts
    these counts on the card."""
    from bench_train import _build_batch

    from padt_tpu_torch.ops import cuda_attention as C
    from padt_tpu_torch.ops import cuda_flash_bwd as FB
    from padt_tpu_torch.train import train_step as TS

    cfg, _, tp = tiny_params(0)
    cfg = cfg.replace(max_image_patches=256)
    lp, lc = 96, 32
    batch, canvas_hw = _build_batch(cfg, 2, (1, 16, 16), lp, lc)
    host = {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16 else np.asarray(v) for k, v in batch.items()}
    tcfg = torch_cfg(cfg)
    calls = {}
    _count_calls(monkeypatch, calls, TA, "rope_qk", "segment_flash_fwd", "window_slot_attn", "flash_bwd_dq", "flash_bwd_dkv")
    _count_calls(monkeypatch, calls, C, "rope_qk", "segment_flash_fwd", "window_slot_attn")
    params = {k: ({kk: (dict(vv) if isinstance(vv, dict) else vv) for kk, vv in v.items()} if isinstance(v, dict) else v)
              for k, v in tp.items()}
    leaves = []

    def mark(tree):
        for v in tree.values():
            if isinstance(v, dict):
                mark(v)
            else:
                v.requires_grad_(True)
                leaves.append(v)

    mark(params)
    try:
        loss, _ = TS.padt_loss(params, tcfg, {k: torch.as_tensor(v.copy()) for k, v in host.items()}, lp, canvas_hw,
                               TS.LossConfig(freeze_vision=False), False)
        loss.backward()
    finally:
        for t in leaves:
            t.grad = None
            t.requires_grad_(False)
    want = TS.train_step_launches(tcfg, slot_layout="pack_index" in host, freeze_vision=False)
    assert calls == {k: n for k, n in want.items() if n}, (calls, want)
    vc, nl = tcfg.vision, tcfg.text.num_hidden_layers
    assert want["flash_bwd_dq"] == want["flash_bwd_dkv"] == nl + vc.depth
    assert want.get("window_slot_attn", 0) == 0
    assert FB.launch_counts == {"flash_bwd_dq": 0, "flash_bwd_dkv": 0}  # the CPU runs the twins
