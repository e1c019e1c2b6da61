"""The vision tower's packed serving layout (`vision.pack_vision_blocks`,
reached through `padt.pack_inference_params`) on the CPU: the layout at the
padded width with exact zeros, idempotence, the packed tower against the
plain one and against JAX's (padt_tiny, float32, the tower parity tests'
tolerance 1e-5 relative; with random biases, so the bias epilogue is held
too) at the tiny ff (128, already aligned) and at a ragged ff (100,
packed to 104), the SwiGLU twin against `F.silu(gate) * up`, and the unpacked path
under grad mode."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from test_torch_common import close, seeded_image, torch_cfg
from padt_tpu.config import padt_tiny
from padt_tpu.models import padt as JP
from padt_tpu.models.vision import vision_forward as jax_vision_forward
from padt_tpu_torch.convert.from_jax import params_from_numpy
from padt_tpu_torch.models import padt as TP
from padt_tpu_torch.models import vision as V
from padt_tpu_torch.models.vision_geom import vision_geometry
from padt_tpu_torch.ops import cuda_mlp

GRIDS = [(1, 8, 12), (1, 16, 16)]
T = lambda a: torch.tensor(np.asarray(a))
BIASES = ("qkv_b", "proj_b", "gate_b", "up_b", "down_b")


def _params(ff=None, seed=0):
    """(JAX cfg, JAX params, torch params) on padt_tiny, the tower's ff set
    to `ff` where given, every tower bias random (JAX inits them to 0)."""
    cfg = padt_tiny()
    if ff is not None:
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, intermediate_size=ff))
    jp = JP.init_padt_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    rng = np.random.default_rng(seed)
    blocks = jp["vision"]["blocks"]
    for k in BIASES:
        blocks[k] = jnp.asarray(rng.normal(0.0, 0.1, blocks[k].shape).astype(np.float32))
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _tower_args(cfg, slots):
    s = cfg.max_image_patches
    geo = vision_geometry(GRIDS, s, window_slots=slots)
    pix = np.zeros((len(GRIDS), s, cfg.vision.patch_input_dim), np.float32)
    for i, g in enumerate(GRIDS):
        pix[i, : g[1] * g[2]] = seeded_image(g, i, u8=False).pixel_patches
    args = [pix, geo.window_index, geo.inv_window_index, geo.seg_win, geo.seg_full, geo.hpos, geo.wpos]
    return geo, args


def _outputs(out):
    merged, high_res, (cos, sin) = out
    return merged, high_res, cos, sin


def test_packed_width_rule():
    assert V.packed_ff(3420) == 3424 and V.packed_ff(3420, 64) == 3456 == 27 * 128
    assert V.packed_ff(128) == 128 and V.packed_ff(100) == 104 and V.packed_ff(100, 64) == 128


@pytest.mark.parametrize("ff,multiple", [(None, V.FF_MULTIPLE), (100, V.FF_MULTIPLE), (100, 64)])
def test_pack_gives_the_padded_layout_with_exact_zeros(ff, multiple):
    _, _, tp = _params(ff)
    blocks = tp["vision"]["blocks"]
    depth, d, f = blocks["gate_w"].shape
    fp = V.packed_ff(f, multiple)
    pk = V.pack_vision_blocks(blocks, multiple)
    assert fp % multiple == 0 and fp >= f and fp % 8 == 0
    assert not {"gate_w", "up_w", "gate_b", "up_b"} & set(pk)
    gw, gb, dw = pk["gateup_w"], pk["gateup_b"], pk["down_w"]
    assert gw.shape == (depth, d, 2 * fp) and gb.shape == (depth, 2 * fp) and dw.shape == (depth, fp, d)
    assert torch.equal(gw[..., :f], blocks["gate_w"]) and torch.equal(gw[..., fp : fp + f], blocks["up_w"])
    assert torch.equal(gb[:, :f], blocks["gate_b"]) and torch.equal(gb[:, fp : fp + f], blocks["up_b"])
    assert torch.equal(dw[:, :f], blocks["down_w"])
    for pad in (gw[..., f:fp], gw[..., fp + f :], gb[:, f:fp], gb[:, fp + f :], dw[:, f:]):
        assert torch.count_nonzero(pad) == 0
    for k in ("norm1_w", "norm2_w", "qkv_w", "qkv_b", "proj_w", "proj_b", "down_b"):
        assert pk[k] is blocks[k]


def test_pack_inference_params_is_idempotent_over_both_halves():
    _, _, tp = _params(100)
    packed = TP.pack_inference_params(tp)
    assert TP.pack_inference_params(packed) is packed
    assert "gateup_w" in packed["vision"]["blocks"] and "qkv_w" in packed["text"]["layers"]
    assert "gate_w" in tp["vision"]["blocks"] and "q_w" in tp["text"]["layers"]  # the input is left as it was
    # a tree whose text half is packed already still gets its tower packed, and the text leaves are kept
    half = dict(tp, text=dict(tp["text"], layers=packed["text"]["layers"]))
    again = TP.pack_inference_params(half)
    assert again["text"]["layers"] is packed["text"]["layers"] and "gateup_w" in again["vision"]["blocks"]
    # a tree without a tower (a text stack alone) packs its text half only
    text_only = TP.pack_inference_params({"text": tp["text"]})
    assert set(text_only) == {"text"} and "qkv_w" in text_only["text"]["layers"]


@pytest.mark.parametrize("ff", [None, 100])
@pytest.mark.parametrize("slots", [True, False])
def test_packed_tower_matches_unpacked_and_jax(ff, slots):
    """(merged, high_res, cos, sin) of the packed tower: equal to the plain
    tower's within float32 rounding and to JAX's within the tower parity
    tests' tolerance, on both token layouts; and in bf16 within bf16
    rounding of the plain tower's."""
    cfg, jp, tp = _params(ff, seed=1)
    tcfg = torch_cfg(cfg).vision
    geo, args = _tower_args(cfg, slots)
    pack = None if geo.pack_index is None else geo.pack_index
    jout = jax_vision_forward(jp["vision"], cfg.vision, *map(jnp.asarray, args),
                              pack_index=None if pack is None else jnp.asarray(pack))
    packed = TP.pack_inference_params(tp)["vision"]
    run = lambda p, dtype=torch.float32: _outputs(_forward(p, tcfg, args, pack, dtype))
    with torch.no_grad():
        plain, ours = run(tp["vision"]), run(packed)
        plain16, ours16 = run(tp["vision"], torch.bfloat16), run(packed, torch.bfloat16)
    for i in range(len(GRIDS)):
        nm, npch = geo.num_merged[i], geo.num_patches[i]
        for a, b, j, n in zip(ours, plain, _outputs(jout), (nm, npch, npch, npch)):
            close(a[i, :n], b[i, :n].numpy())
            close(a[i, :n], np.asarray(j)[i, :n])
    for a, b in zip(ours16, plain16):  # bf16: a few roundings apart, relative to the output's scale
        close(a.float(), b.float().numpy(), tol=3e-2)


def _forward(p, tcfg, args, pack, dtype):
    """`vision_forward` on the tree `p` cast to `dtype`."""
    cast = lambda t: {k: cast(v) for k, v in t.items()} if isinstance(t, dict) else t.to(dtype)
    return V.vision_forward(cast(p), tcfg, *map(T, args), pack_index=None if pack is None else T(pack))


@pytest.mark.parametrize("shape", [(7, 2 * 104), (2, 5, 2 * 3456), (0, 16)])
def test_swiglu_twin_equals_silu_times_up(shape):
    """The twin (fp32 inside, one rounding) against `F.silu(gate) * up`:
    equal in float32; in bf16 (two roundings there) within one bf16 ulp of
    each value."""
    g = torch.Generator().manual_seed(0)
    gu = torch.randn(shape, generator=g) * 3.0
    gate, up = gu.chunk(2, dim=-1)
    assert torch.equal(cuda_mlp.swiglu(gu), F.silu(gate) * up)
    assert torch.equal(cuda_mlp.swiglu_plain(gu), F.silu(gate) * up)
    h = gu.to(torch.bfloat16)
    out, ref = cuda_mlp.swiglu(h), F.silu(h[..., : shape[-1] // 2]) * h[..., shape[-1] // 2 :]
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp(min=2.0**-126))) - 7)
    assert bool(((out.float() - ref.float()).abs() <= ulp).all())


def _count_swiglu(monkeypatch):
    calls = []
    real = V.swiglu
    monkeypatch.setattr(V, "swiglu", lambda gu: calls.append(gu.shape) or real(gu))
    return calls


def test_grad_mode_takes_the_unpacked_path(monkeypatch):
    """The trainer's plain tree under grad mode (remat on, as `padt_loss`
    runs it): no SwiGLU call, the gradient reaches the plain MLP leaves; the
    packed tree runs one SwiGLU call per block."""
    cfg, _, tp = _params(100)
    tcfg = torch_cfg(cfg).vision
    geo, args = _tower_args(cfg, True)
    calls = _count_swiglu(monkeypatch)
    p = {k: v.requires_grad_(True) for k, v in tp["vision"]["blocks"].items()}
    tree = dict(tp["vision"], blocks=p)
    merged, high_res, _ = V.vision_forward(tree, tcfg, *map(T, args), remat=True, pack_index=T(geo.pack_index))
    (merged.square().sum() + high_res.square().sum()).backward()
    assert calls == [] and all(p[k].grad is not None and p[k].grad.abs().sum() > 0 for k in ("gate_w", "up_w", "down_w"))
    with torch.no_grad():
        V.vision_forward(TP.pack_inference_params(tp)["vision"], tcfg, *map(T, args), pack_index=T(geo.pack_index))
    fp = V.packed_ff(100)
    assert len(calls) == cfg.vision.depth and all(s[-1] == 2 * fp for s in calls)


def test_engine_holds_only_the_packed_tower():
    """A `ServeEngine` packs its tree once and keeps no reference to the
    plain tower MLP leaves; `InferenceEngine` adopts the engine's tree, so
    `run_batch` runs on the packed tower too."""
    from padt_tpu_torch.eval.harness import InferenceEngine
    from padt_tpu_torch.serve import ServeEngine

    cfg, _, tp = _params(100)
    tcfg = torch_cfg(cfg)
    eng = ServeEngine(tp, tcfg, n_slots=2, max_new_tokens=4, prompt_len=64)
    blocks = eng.params["vision"]["blocks"]
    assert "gateup_w" in blocks and not {"gate_w", "up_w", "gate_b", "up_b"} & set(blocks)
    plain = {id(v) for k, v in tp["vision"]["blocks"].items() if k in ("gate_w", "up_w", "down_w", "gate_b", "up_b")}
    assert not plain & {id(v) for v in blocks.values()}
    harness = InferenceEngine(tp, tcfg, processor=None, max_new_tokens=4)
    served = harness._serve_engine(n_slots=2, prompt_len=64)
    assert harness.params is served.params and "gateup_w" in harness.params["vision"]["blocks"]
