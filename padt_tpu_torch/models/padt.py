"""PaDT core model on PyTorch (port of `padt_tpu/models/padt.py`): the
visual prototype projection, the extended (text + per-sample VRT)
vocabulary, generation, and the `vl_decode` glue to the perception decoder.

Same conventions as the JAX package: per-sample prototype tables, VRT token
id == vocab_size + local merged-patch id, hidden states captured per
generated token. `generate` is an eager Python loop that checks once per
step whether every row has finished. `forward_train` is the teacher-forced
training forward; a frozen tower runs under `torch.no_grad()` (JAX's
stop_gradient) or is skipped for cached `vis_*` features.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import PaDTConfig, text_opt
from ..ops.norms import layer_norm
from ..ops.quant import quantize_weight
from ..preprocess.vision_process import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD
from . import language
from .decoder import decoder_forward, init_decoder_params
from .params import normal, ones, zeros
from .vision import init_vision_params, pack_vision_blocks, vision_forward

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_padt_params(cfg: PaDTConfig, generator: torch.Generator, device, dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random parameter tree with the JAX tree's keys, shapes and dtypes
    (`padt_tpu.models.padt.init_padt_params`); values come from `generator`."""
    params: Dict[str, Any] = {
        "vision": init_vision_params(cfg.vision, generator, device, dtype),
        "text": language.init_text_params(cfg.text, generator, device, dtype),
        "decoder": init_decoder_params(cfg.decoder, generator, device, dtype),
    }
    if cfg.use_visual_prototype_projection:
        params["proto"] = init_proto_params(cfg, generator, device, dtype)
    return params


def init_proto_params(cfg: PaDTConfig, generator: torch.Generator, device, dtype=torch.bfloat16) -> Dict[str, Any]:
    """The visual prototype projection's leaves (ZeroInitLayerNorm: weight
    and bias zero)."""
    d, r = cfg.text.hidden_size, cfg.prototype_proj_rank
    return {
        "ln_w": zeros((d,), device, dtype),
        "ln_b": zeros((d,), device, dtype),
        "down_w": normal(generator, (d, r), device, dtype),
        "up_w": normal(generator, (r, d), device, dtype),
    }


def init_padt_params_quantized(
    cfg: PaDTConfig, generator: torch.Generator, device, dtype=torch.bfloat16, packed: bool = False
) -> Dict[str, Any]:
    """Random init with the text-layer weights made directly in the
    `quantize_params` layout (`padt_tpu.models.padt.init_padt_params_quantized`):
    int8 values uniform in [-127, 127], one layer at a time, and fp32 scales
    0.02 / 73 (the uniform int8 std is ~73, so the dequantized weights match
    the dense init's 0.02 std); the other leaves as `init_padt_params` makes
    them in `dtype`. packed=True builds the fused `qkv_w_q` / `gateup_w_q`
    serving layout directly."""
    tc = cfg.text
    if text_opt(tc, "num_experts"):
        raise NotImplementedError("int8 text weights for a sparse-expert stack are not implemented")
    params = init_padt_params(cfg.replace(text=dataclasses.replace(tc, num_hidden_layers=0)), generator, device, dtype)
    nl, d, ff = tc.num_hidden_layers, tc.hidden_size, tc.intermediate_size
    qd = tc.num_attention_heads * tc.head_dim
    kvd = tc.num_key_value_heads * tc.head_dim
    layers = {"input_ln_w": ones((nl, d), device, dtype), "post_ln_w": ones((nl, d), device, dtype)}
    if packed:
        shapes = {"qkv_w": (d, qd + 2 * kvd), "o_w": (qd, d), "gateup_w": (d, 2 * ff), "down_w": (ff, d)}
        layers["qkv_b"] = zeros((nl, qd + 2 * kvd), device, dtype)
    else:
        shapes = {"q_w": (d, qd), "k_w": (d, kvd), "v_w": (d, kvd), "o_w": (qd, d),
                  "gate_w": (d, ff), "up_w": (d, ff), "down_w": (ff, d)}
        layers.update(q_b=zeros((nl, qd), device, dtype), k_b=zeros((nl, kvd), device, dtype),
                      v_b=zeros((nl, kvd), device, dtype))
    for name, shp in shapes.items():
        q = torch.empty((nl, *shp), dtype=torch.int8, device=device)
        for li in range(nl):
            q[li] = torch.randint(-127, 128, shp, generator=generator, device=device, dtype=torch.int8)
        layers[name + "_q"] = q
        layers[name + "_s"] = torch.full((nl, 1, shp[1]), 0.02 / 73.0, dtype=torch.float32, device=device)
    params["text"]["layers"] = layers
    return params


_QUANT_LAYER_WEIGHTS = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Text-layer weights -> per-output-channel int8 `{name}_q` (L, in, out)
    and fp32 scales `{name}_s` (L, 1, out); every other leaf is shared with
    `params`. One layer at a time, so no all-layer fp32 copy is ever held."""
    layers = dict(params["text"]["layers"])
    if "router_w" in layers:
        raise NotImplementedError("int8 text weights for a sparse-expert stack are not implemented")
    for name in _QUANT_LAYER_WEIGHTS:
        w = layers.pop(name)  # (L, in, out)
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = torch.empty((w.shape[0], 1, w.shape[2]), dtype=torch.float32, device=w.device)
        for li in range(w.shape[0]):
            qs = quantize_weight(w[li])
            q[li], s[li] = qs["q"], qs["s"]
        layers[name + "_q"], layers[name + "_s"] = q, s
    out = dict(params)
    out["text"] = dict(params["text"], layers=layers)
    return out


def pack_inference_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Fuse the text layers' weight streams for serving: q|k|v -> `qkv_w`
    (L, d, (H+2*Hkv)*hd) and `qkv_b` (where the layers have biases),
    gate|up -> `gateup_w` (L, d, 2*ff; an expert stack is fused already); on
    the int8 layout the values and the per-column scales concatenate the
    same way (`qkv_w_q` / `qkv_w_s`, `gateup_w_q` / `gateup_w_s`). Exact:
    each output column depends only on its own weight column. The vision
    tower's blocks, where the tree has them, take their aligned serving
    layout (`vision.pack_vision_blocks`: `gateup_w`, `gateup_b`, `down_w` at
    a padded width). Idempotent; the other leaves are shared with `params`,
    which is left as it was."""
    layers = _pack_text_layers(params["text"]["layers"])
    vision = params.get("vision")
    blocks = pack_vision_blocks(vision["blocks"]) if vision is not None else None
    if layers is params["text"]["layers"] and (vision is None or blocks is vision["blocks"]):
        return params
    out = dict(params)
    out["text"] = dict(params["text"], layers=layers)
    if vision is not None:
        out["vision"] = dict(vision, blocks=blocks)
    return out


def _pack_text_layers(layers: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`pack_inference_params`' text half: `layers` itself where packed."""
    if "qkv_w" in layers or "qkv_w_q" in layers:
        return layers
    layers = dict(layers)
    cat = lambda names: torch.cat([layers.pop(n) for n in names], dim=-1)
    if "q_w_q" in layers:
        for suffix in ("_q", "_s"):
            layers["qkv_w" + suffix] = cat(("q_w" + suffix, "k_w" + suffix, "v_w" + suffix))
            layers["gateup_w" + suffix] = cat(("gate_w" + suffix, "up_w" + suffix))
    else:
        layers["qkv_w"] = cat(("q_w", "k_w", "v_w"))
        if "gate_w" in layers:
            layers["gateup_w"] = cat(("gate_w", "up_w"))
    if "q_b" in layers:
        layers["qkv_b"] = cat(("q_b", "k_b", "v_b"))
    return layers


class _Tree(torch.nn.Module):
    """Registers a nested dict of tensors as buffers / submodules, so the
    tree moves with `.to()` and appears in `state_dict()` under dotted keys."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_buffer(k, v)

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.named_buffers(recurse=False))
        for k, m in self.named_children():
            out[k] = m.as_dict()
        return out


class PaDTModel(torch.nn.Module):
    """Holds the parameter tree (same keys and layouts as the JAX tree) and
    exposes `generate` and `vl_decode`."""

    def __init__(self, cfg: PaDTConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.tree = _Tree(params)

    @property
    def params(self) -> Dict[str, Any]:
        return self.tree.as_dict()

    @torch.no_grad()
    def generate(self, batch, max_new_tokens: int, rope_deltas, **kw) -> "GenerateOutput":
        return generate(self.params, self.cfg, batch, max_new_tokens, rope_deltas, **kw)

    @torch.no_grad()
    def vl_decode(self, vrt_feats, vrt_counts, obj_valid, obj_sample, art, **kw):
        return vl_decode(self.params, self.cfg, vrt_feats, vrt_counts, obj_valid, obj_sample, art, **kw)


def image_prototypes(params, cfg: PaDTConfig, merged: torch.Tensor) -> torch.Tensor:
    """merged (B, M, D) raster order -> prototypes (B, M, D)."""
    if not cfg.use_visual_prototype_projection:
        return merged
    p = params["proto"]
    x = layer_norm(merged, p["ln_w"], p["ln_b"], eps=1e-5)
    return x + (x @ p["down_w"]) @ p["up_w"]


# ---------------------------------------------------------------------------
# Extended vocabulary
# ---------------------------------------------------------------------------

def extended_embed(params, cfg: PaDTConfig, input_ids, proto, merged=None):
    """Token embeddings over the extended vocab: ids >= vocab_size read the
    sample's prototype table; with `merged`, image/video pad runs are
    overwritten by the raster-order merged embeddings."""
    v = cfg.text.vocab_size
    embed = params["text"]["embed"]
    ids = input_ids.long()
    is_vrt = ids >= v
    text_e = embed[ids.clamp(0, v - 1)]
    local = (ids - v).clamp(0, proto.shape[1] - 1)
    vrt_e = torch.gather(proto, 1, local[:, :, None].expand(-1, -1, proto.shape[-1]))
    out = torch.where(is_vrt[:, :, None], vrt_e.to(text_e.dtype), text_e)
    if merged is not None:
        is_img = (ids == cfg.image_token_id) | (ids == cfg.video_token_id)
        slot = (torch.cumsum(is_img.long(), dim=1) - 1).clamp(0, merged.shape[1] - 1)
        img_e = torch.gather(merged, 1, slot[:, :, None].expand(-1, -1, merged.shape[-1]))
        out = torch.where(is_img[:, :, None], img_e.to(out.dtype), out)
    return out


class _F32Logits(torch.autograd.Function):
    """bf16 h (N, D) @ w (V, D)^T with fp32 accumulation and fp32 output on
    the card. The backward runs the two bf16 products (fp32 accumulation,
    bf16 results) on the cotangent rounded to bf16: dh = g @ w, dw = g^T @ h."""

    @staticmethod
    def forward(ctx, h2, w):
        ctx.save_for_backward(h2, w)
        return torch.mm(h2, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h2, w = ctx.saved_tensors
        g = g.to(h2.dtype)
        return g @ w, g.t() @ h2


def _f32_logits(hidden: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """hidden (B, L, D) @ w(V, D)^T with f32 output. A bf16 product keeps
    f32 accumulation and f32 output (JAX's preferred_element_type=f32), so
    near-ties in the argmax are not decided by bf16 rounding."""
    b, l, d = hidden.shape
    h2 = hidden.reshape(b * l, d)
    if hidden.dtype == torch.float32:
        out = h2 @ w.t()
    elif hidden.is_cuda:
        out = _F32Logits.apply(h2, w)
    else:
        out = h2.float() @ w.float().t()
    return out.reshape(b, l, -1)


def extended_logits_pair(params, cfg: PaDTConfig, hidden, proto, num_merged):
    """((B, L, V) text logits, (B, L, M) VRT logits) in f32; VRT slots at or
    past a sample's num_merged are NEG_INF."""
    w = params["text"]["embed"] if cfg.text.tie_word_embeddings else params["text"]["lm_head"]
    lt = _f32_logits(hidden, w)
    lv = torch.einsum("bld,bmd->blm", hidden.float(), proto.float())
    slot_ok = torch.arange(proto.shape[1], device=proto.device)[None, :] < num_merged[:, None]
    lv = torch.where(slot_ok[:, None, :], lv, NEG_INF)
    return lt, lv


def extended_logits(params, cfg: PaDTConfig, hidden, proto, num_merged):
    """(B, L, V + M) concatenated extended logits."""
    return torch.cat(extended_logits_pair(params, cfg, hidden, proto, num_merged), dim=-1)


# ---------------------------------------------------------------------------
# Vision
# ---------------------------------------------------------------------------

class VisionArtifacts(NamedTuple):
    """Vision-side tensors the perception decoder consumes."""

    merged: torch.Tensor  # (B, M, D_llm) raster order
    proto: torch.Tensor  # (B, M, D_llm) raster order
    high_res: torch.Tensor  # (B, S, D_vis) window order
    pe_cos: torch.Tensor  # (B, S, head_dim_vis) window order
    pe_sin: torch.Tensor
    num_merged: torch.Tensor  # (B,)
    num_patches: torch.Tensor  # (B,)
    grid_thw: torch.Tensor  # (B, 3)


_VISION_BATCH_KEYS = (
    "pixel_patches", "pixel_patches_u8", "window_index", "inv_window_index",
    "seg_win", "seg_full", "hpos", "wpos", "num_merged", "num_patches", "grid_thw", "pack_index",
)

# batch keys read only by the tower: a batch with cached `vis_*` features
# drops them
_VISION_ONLY_KEYS = (
    "pixel_patches", "pixel_patches_u8", "window_index", "inv_window_index",
    "seg_win", "seg_full", "hpos", "wpos", "pack_index",
)
_VISION_CACHE_KEYS = ("vis_merged", "vis_high_res", "vis_pe_cos", "vis_pe_sin")
# int8 feature cache: merged / high_res as per-row int8 + fp32 row scales,
# the rope tables exact
_VISION_CACHE_KEYS_INT8 = (
    "vis_merged_q", "vis_merged_s", "vis_high_res_q", "vis_high_res_s", "vis_pe_cos", "vis_pe_sin",
)


def vision_cache_keys(quant: str = "none"):
    return _VISION_CACHE_KEYS_INT8 if quant == "int8" else _VISION_CACHE_KEYS


def _quant_rows(x: torch.Tensor):
    """Per-row (last axis) symmetric int8: q in [-127, 127] (round half to
    even), fp32 scales (..., 1) of at least 1e-12."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def _dequant_rows(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * s).to(dtype)


def vision_features(params, cfg: PaDTConfig, batch, quant: str = "none"):
    """Run the frozen tower once and return the `vis_*` batch keys that make
    `run_vision` / `forward_train` skip it: exactly loss- and
    gradient-equivalent under freeze_vision, since the graph is cut at
    these tensors anyway. quant "int8": merged / high_res as per-row int8 +
    fp32 scales (a bounded forward perturbation), the rope tables exact."""
    with torch.no_grad():
        art = run_vision(params, cfg, batch, freeze=True)
    if quant == "int8":
        mq, ms = _quant_rows(art.merged)
        hq, hs = _quant_rows(art.high_res)
        return {"vis_merged_q": mq, "vis_merged_s": ms, "vis_high_res_q": hq, "vis_high_res_s": hs,
                "vis_pe_cos": art.pe_cos, "vis_pe_sin": art.pe_sin}
    return {"vis_merged": art.merged, "vis_high_res": art.high_res, "vis_pe_cos": art.pe_cos, "vis_pe_sin": art.pe_sin}


@functools.lru_cache(maxsize=None)
def _pixel_u8_lut(dtype=torch.float32, device=None) -> torch.Tensor:
    """(3, 256) per-channel table lut[c, v] = (f32(v)/255 - mean[c]) / std[c],
    built with the numpy expression the host pipeline uses; made once per
    dtype and device (a copy from the host a call would wait for the
    device's queue to drain)."""
    v = np.arange(256, dtype=np.float32) / np.float32(255.0)
    mean = np.asarray(OPENAI_CLIP_MEAN, np.float32)[:, None]
    std = np.asarray(OPENAI_CLIP_STD, np.float32)[:, None]
    return torch.as_tensor((v[None, :] - mean) / std, device=device).to(dtype)


def _expand_pixels_u8(cfg: PaDTConfig, u8, num_patches, dtype=torch.bfloat16):
    """Compact uint8 rows (B, S, C*P*P) -> normalized pixel_patches
    (B, S, C*tP*P*P): LUT gather, temporal duplication (an image's two
    temporal copies are the same frame), zeroed padding rows."""
    vc = cfg.vision
    if vc.in_channels != 3 or vc.temporal_patch_size != 2:
        raise ValueError("the uint8 pixel format is defined for 3 channels and temporal patch 2")
    b, s, d = u8.shape
    c = vc.in_channels
    pp = d // c
    lut = _pixel_u8_lut(dtype, u8.device)
    x = lut[torch.arange(c, device=u8.device)[None, None, :, None], u8.reshape(b, s, c, pp).long()]
    x = x[:, :, :, None, :].expand(b, s, c, vc.temporal_patch_size, pp).reshape(b, s, 2 * d)
    valid = (torch.arange(s, device=u8.device)[None, :] < num_patches[:, None])[:, :, None]
    return torch.where(valid, x, torch.zeros((), dtype=dtype, device=u8.device))


def _run_vision_once(params, cfg: PaDTConfig, batch, freeze: bool = False, remat: bool = False) -> VisionArtifacts:
    pix = batch.get("pixel_patches")
    if pix is None:
        pix = _expand_pixels_u8(cfg, batch["pixel_patches_u8"], batch["num_patches"])
    # freeze (`--freeze_vision_modules`): the tower runs without a graph, the
    # port's stop_gradient; the prototype projection below stays trainable
    with torch.no_grad() if freeze else contextlib.nullcontext():
        merged, high_res, (cos, sin) = vision_forward(
            params["vision"], cfg.vision, pix,
            batch["window_index"], batch["inv_window_index"], batch["seg_win"], batch["seg_full"],
            batch["hpos"], batch["wpos"], remat=remat, pack_index=batch.get("pack_index"),
        )
    return VisionArtifacts(
        merged=merged, proto=image_prototypes(params, cfg, merged), high_res=high_res,
        pe_cos=cos, pe_sin=sin, num_merged=batch["num_merged"],
        num_patches=batch["num_patches"], grid_thw=batch["grid_thw"],
    )


def run_vision(params, cfg: PaDTConfig, batch: Dict[str, torch.Tensor], freeze: bool = False,
               remat: bool = False) -> VisionArtifacts:
    """Vision tower + prototypes; with `cfg.vision_chunk_size` set (and
    dividing B), the tower runs over batch chunks to bound transients (each
    chunk's blocks, and their checkpoints under `remat`, see only that
    chunk's segment ids and tables). A batch with cached `vis_*` features
    (`vision_features`) skips the tower and recomputes only the prototypes;
    that needs freeze=True."""
    if "vis_merged" in batch or "vis_merged_q" in batch:
        if not freeze:
            raise ValueError(
                "cached vision features (vis_* batch keys) are exact only under freeze_vision=True: the "
                "tower graph is skipped entirely, so an unfrozen tower's gradients would be silently zero"
            )
        if "vis_merged_q" in batch:
            dt = batch["vis_pe_cos"].dtype
            merged = _dequant_rows(batch["vis_merged_q"], batch["vis_merged_s"], dt)
            high_res = _dequant_rows(batch["vis_high_res_q"], batch["vis_high_res_s"], dt)
        else:
            merged, high_res = batch["vis_merged"], batch["vis_high_res"]
        return VisionArtifacts(
            merged=merged, proto=image_prototypes(params, cfg, merged), high_res=high_res,
            pe_cos=batch["vis_pe_cos"], pe_sin=batch["vis_pe_sin"], num_merged=batch["num_merged"],
            num_patches=batch["num_patches"], grid_thw=batch["grid_thw"],
        )
    pix_key = "pixel_patches" if "pixel_patches" in batch else "pixel_patches_u8"
    b = batch[pix_key].shape[0]
    cs = cfg.vision_chunk_size
    if cs and b > cs and b % cs == 0:
        parts = [
            _run_vision_once(params, cfg, {k: batch[k][i : i + cs] for k in _VISION_BATCH_KEYS if k in batch}, freeze,
                             remat)
            for i in range(0, b, cs)
        ]
        return VisionArtifacts(*(torch.cat(xs) for xs in zip(*parts)))
    return _run_vision_once(params, cfg, batch, freeze, remat)


def forward_train(
    params,
    cfg: PaDTConfig,
    batch: Dict[str, torch.Tensor],
    logits_slice: Optional[Tuple[int, int]] = None,
    remat: bool = False,
    freeze_vision: bool = False,
    split_logits: bool = False,
):
    """Teacher-forced forward. logits_slice=(start, length): logits only for
    hidden positions [start, start + length) (the completion). Returns
    (logits: (B, Lc, V + M) fp32, or the ((B, Lc, V), (B, Lc, M)) pair with
    split_logits; hidden (B, L, D); the vision artifacts)."""
    art = run_vision(params, cfg, batch, freeze=freeze_vision, remat=remat)
    embeds = extended_embed(params, cfg, batch["input_ids"], art.proto, art.merged)
    hidden, _ = language.text_forward(
        params["text"], cfg.text, embeds, batch["position_ids"], batch["attention_mask"].bool(), remat=remat,
    )
    h = hidden
    if logits_slice is not None:
        start, length = logits_slice
        h = hidden[:, start : start + length]
    fn = extended_logits_pair if split_logits else extended_logits
    return fn(params, cfg, h, art.proto, art.num_merged), hidden, art


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------

def sample_token(
    logits: torch.Tensor,  # (B, Vext) f32
    generator: Optional[torch.Generator] = None,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> torch.Tensor:
    """Greedy (first maximum) or temperature/top-k/top-p sampling."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k is not None and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p  # always keeps the argmax
        inf = torch.full_like(sorted_logits, float("inf"))
        threshold = torch.where(keep, sorted_logits, inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < threshold, NEG_INF, logits)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)[:, 0]


class GenerateOutput(NamedTuple):
    tokens: torch.Tensor  # (B, T) generated tokens, pad after EOS
    hidden: torch.Tensor  # (B, T, D) final-norm hidden that produced each token
    num_generated: torch.Tensor  # (B,) tokens up to and including EOS
    artifacts: VisionArtifacts


@torch.no_grad()
def generate(
    params,
    cfg: PaDTConfig,
    batch: Dict[str, torch.Tensor],
    max_new_tokens: int,
    rope_deltas: torch.Tensor,  # (B,)
    do_sample: bool = False,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    eos_token_id: Optional[int] = None,
    kv_cache_dtype: str = "bf16",
    prefill_batch_chunk: Optional[int] = None,
) -> GenerateOutput:
    """Vision + prefill + a decode loop, with the JAX semantics: a finished
    row emits pad_token_id, num_generated counts the EOS, hidden[:, t] is the
    post-final-norm hidden state that produced token t, and the loop stops
    once every row has finished (one host check per step).
    kv_cache_dtype "int8" keeps the cache in int8 (H4 decode attention, H6
    row store) with its capacity rounded up to a multiple of 128."""
    if kv_cache_dtype not in ("bf16", "int8"):
        raise ValueError(f"unknown kv_cache_dtype {kv_cache_dtype!r}")
    eos = cfg.eos_token_id if eos_token_id is None else eos_token_id
    tcfg = cfg.text
    b, l = batch["input_ids"].shape
    dev = batch["input_ids"].device
    dtype = params["text"]["embed"].dtype

    capacity = l + max_new_tokens
    if kv_cache_dtype == "int8":
        capacity = -(-capacity // 128) * 128  # as the JAX package sizes it

    art = run_vision(params, cfg, batch)
    embeds = extended_embed(params, cfg, batch["input_ids"], art.proto, art.merged)
    valid = batch["attention_mask"].bool()
    hidden, cache = language.prefill(
        params["text"], tcfg, embeds, batch["position_ids"], valid, capacity,
        kv_dtype=kv_cache_dtype, batch_chunk=prefill_batch_chunk,
    )
    cur = hidden[:, -1:, :]  # predicts the first new token

    tokens = torch.full((b, max_new_tokens), cfg.pad_token_id, dtype=torch.int64, device=dev)
    hidden_buf = torch.zeros((b, max_new_tokens, tcfg.hidden_size), dtype=dtype, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    num_gen = torch.zeros((b,), dtype=torch.int32, device=dev)
    deltas = rope_deltas.to(dev).long()
    for step in range(max_new_tokens):
        logits = extended_logits(params, cfg, cur, art.proto, art.num_merged)[:, 0]
        tok = sample_token(logits, generator, do_sample, temperature, top_k, top_p)
        tok = torch.where(finished, cfg.pad_token_id, tok)
        tokens[:, step] = tok
        hidden_buf[:, step] = cur[:, 0]
        num_gen += (~finished).int()
        finished |= tok == eos
        if step + 1 == max_new_tokens or bool(finished.all()):
            break
        emb = extended_embed(params, cfg, tok[:, None], art.proto)
        pos = (l + step + deltas)[None, :, None].expand(3, b, 1)
        cur, cache = language.decode_step(params["text"], tcfg, emb, pos, cache)
    return GenerateOutput(tokens=tokens, hidden=hidden_buf, num_generated=num_gen, artifacts=art)


# ---------------------------------------------------------------------------
# vl_decode glue
# ---------------------------------------------------------------------------

def vl_decode(
    params,
    cfg: PaDTConfig,
    vrt_feats,  # (N, K_max, D_llm) parser-gathered VRT hidden states
    vrt_counts,  # (N,)
    obj_valid,  # (N,) bool
    obj_sample,  # (N,)
    art: VisionArtifacts,
    canvas_hw: Optional[Tuple[int, int]] = None,
    compute_mask: bool = True,
):
    """Per-object VRT hidden groups -> perception decoder outputs
    (differentiable; `PaDTModel.vl_decode` and the harness run it without
    grad)."""
    if canvas_hw is None:
        side = int(cfg.max_image_patches**0.5) + 1
        canvas_hw = (side, side)
    return decoder_forward(
        params["decoder"], cfg.decoder, vrt_feats, vrt_counts, obj_valid, obj_sample,
        art.proto, art.high_res, art.pe_cos, art.pe_sin, art.num_merged, art.num_patches,
        art.grid_thw, canvas_hw, compute_mask=compute_mask and cfg.decoder.use_mask_head,
    )
