"""HF (PyTorch safetensors) -> PaDT param tree converter (the port's copy of
`padt_tpu/convert/hf_to_padt.py`: the files are read by the port's own
`safetensors_io`, and `convert_checkpoint` makes torch tensors on a device).

Handles both the transformers>=4.52 key layout (`model.visual.*`,
`model.language_model.*`) and the 4.50-era layout the reference pins
(`visual.*`, `model.*`, `lm_head.*`) that released PaDT checkpoints use
(reference `setup.py:20`, checkpoints `PaDT-MLLM/PaDT_*`).

Linear weights are transposed to (in, out) so forward is `x @ w`. The vision
patch-embed Conv3d collapses to a matmul over flattened patch rows (the image
processor already emits rows in (C, tP, P, P) order — see
preprocess/vision_process.py).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterable, Optional

import numpy as np

from ..config import DecoderConfig, PaDTConfig, TextConfig, VisionConfig
from . import safetensors_io


def load_safetensors_dir(path: str) -> Dict[str, np.ndarray]:
    """Load all safetensors shards of an HF checkpoint dir into numpy
    (memmap views; bf16 tensors as their uint16 bits)."""
    return safetensors_io.load_dir(path)


def normalize_keys(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Map any transformers version's naming to the 4.50-era canonical form:
    visual.* / model.* / lm_head.* / vis_norm.* / vis_proj.* / vl_decoder.*"""
    out = {}
    for k, v in sd.items():
        nk = k
        nk = re.sub(r"^model\.visual\.", "visual.", nk)
        nk = re.sub(r"^model\.language_model\.", "model.", nk)
        out[nk] = v
    return out


def _t(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.T)


def _lin(sd, prefix, bias=True):
    p = {"w": _t(sd[f"{prefix}.weight"])}
    if bias and f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def convert_vision(sd: Dict[str, np.ndarray], cfg: VisionConfig) -> Dict[str, Any]:
    depth = cfg.depth
    pe = sd["visual.patch_embed.proj.weight"]  # (D, C, kT, kH, kW)
    params = {
        "patch_embed": {"w": _t(pe.reshape(pe.shape[0], -1))},
        "merger": {
            "ln_q_w": sd["visual.merger.ln_q.weight"],
            "fc1": _lin(sd, "visual.merger.mlp.0"),
            "fc2": _lin(sd, "visual.merger.mlp.2"),
        },
    }

    def stack(fmt, transpose=False):
        mats = [sd[fmt.format(i)] for i in range(depth)]
        if transpose:
            mats = [_t(m) for m in mats]
        return np.stack(mats)

    params["blocks"] = {
        "norm1_w": stack("visual.blocks.{}.norm1.weight"),
        "norm2_w": stack("visual.blocks.{}.norm2.weight"),
        "qkv_w": stack("visual.blocks.{}.attn.qkv.weight", True),
        "qkv_b": stack("visual.blocks.{}.attn.qkv.bias"),
        "proj_w": stack("visual.blocks.{}.attn.proj.weight", True),
        "proj_b": stack("visual.blocks.{}.attn.proj.bias"),
        "gate_w": stack("visual.blocks.{}.mlp.gate_proj.weight", True),
        "gate_b": stack("visual.blocks.{}.mlp.gate_proj.bias"),
        "up_w": stack("visual.blocks.{}.mlp.up_proj.weight", True),
        "up_b": stack("visual.blocks.{}.mlp.up_proj.bias"),
        "down_w": stack("visual.blocks.{}.mlp.down_proj.weight", True),
        "down_b": stack("visual.blocks.{}.mlp.down_proj.bias"),
    }
    return params


def convert_text(sd: Dict[str, np.ndarray], cfg: TextConfig) -> Dict[str, Any]:
    nl = cfg.num_hidden_layers

    def stack(fmt, transpose=False):
        mats = [sd[fmt.format(i)] for i in range(nl)]
        if transpose:
            mats = [_t(m) for m in mats]
        return np.stack(mats)

    params = {
        "embed": sd["model.embed_tokens.weight"],
        "final_ln_w": sd["model.norm.weight"],
        "layers": {
            "input_ln_w": stack("model.layers.{}.input_layernorm.weight"),
            "post_ln_w": stack("model.layers.{}.post_attention_layernorm.weight"),
            "q_w": stack("model.layers.{}.self_attn.q_proj.weight", True),
            "q_b": stack("model.layers.{}.self_attn.q_proj.bias"),
            "k_w": stack("model.layers.{}.self_attn.k_proj.weight", True),
            "k_b": stack("model.layers.{}.self_attn.k_proj.bias"),
            "v_w": stack("model.layers.{}.self_attn.v_proj.weight", True),
            "v_b": stack("model.layers.{}.self_attn.v_proj.bias"),
            "o_w": stack("model.layers.{}.self_attn.o_proj.weight", True),
            "gate_w": stack("model.layers.{}.mlp.gate_proj.weight", True),
            "up_w": stack("model.layers.{}.mlp.up_proj.weight", True),
            "down_w": stack("model.layers.{}.mlp.down_proj.weight", True),
        },
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = sd["lm_head.weight"]  # (V, D), used as-is
    return params


def _attn_params(sd, prefix):
    return {
        "q": _lin(sd, f"{prefix}.q_proj"),
        "k": _lin(sd, f"{prefix}.k_proj"),
        "v": _lin(sd, f"{prefix}.v_proj"),
        "o": _lin(sd, f"{prefix}.proj"),
    }


def _block_params(sd, prefix):
    return {
        **{f"norm{i}_w": sd[f"{prefix}.norm{i}.weight"] for i in range(1, 7)},
        "self_attn": _attn_params(sd, f"{prefix}.self_attn"),
        "cross_q2i": _attn_params(sd, f"{prefix}.cross_attn_query_to_image"),
        "cross_i2q": _attn_params(sd, f"{prefix}.cross_attn_image_to_query"),
        "mlp_fc1": _lin(sd, f"{prefix}.mlp.0"),
        "mlp_fc2": _lin(sd, f"{prefix}.mlp.2"),
    }


def convert_decoder(sd: Dict[str, np.ndarray], cfg: DecoderConfig) -> Dict[str, Any]:
    p = "vl_decoder"
    return {
        "vp_embedding": sd[f"{p}.vp_embedding.weight"][0],
        "bbox_score_mask_tokens": sd[f"{p}.bbox_score_mask_tokens.weight"],
        "input_proj": {
            "norm_w": sd[f"{p}.input_projection.0.weight"],
            "fc1": _lin(sd, f"{p}.input_projection.1"),
            "fc2": _lin(sd, f"{p}.input_projection.3"),
        },
        "low_res": _block_params(sd, f"{p}.low_res_transformer"),
        "high_res1": _block_params(sd, f"{p}.high_res_transformer1"),
        "high_res2": _block_params(sd, f"{p}.high_res_transformer2"),
        "high_res_norm_w": sd[f"{p}.high_res_norm.weight"],
        "bbox_fc1": _lin(sd, f"{p}.bbox_prediction.0"),
        "bbox_fc2": _lin(sd, f"{p}.bbox_prediction.2"),
        "bbox_fc3": _lin(sd, f"{p}.bbox_prediction.4"),
        "score": _lin(sd, f"{p}.score_prediction"),
        "mask_up1": {**_lin(sd, f"{p}.mask_output_upscaling1.0"), "norm_w": sd[f"{p}.mask_output_upscaling1.1.weight"]},
        "mask_up2": _lin(sd, f"{p}.mask_output_upscaling2.0"),
        "mask_mlp_fc1": _lin(sd, f"{p}.mask_output_mlp.0"),
        "mask_mlp_fc2": _lin(sd, f"{p}.mask_output_mlp.2"),
        "mask_mlp_fc3": _lin(sd, f"{p}.mask_output_mlp.4"),
    }


def convert_proto(sd: Dict[str, np.ndarray]) -> Optional[Dict[str, Any]]:
    if "vis_norm.weight" not in sd:
        return None
    return {
        "ln_w": sd["vis_norm.weight"],
        "ln_b": sd["vis_norm.bias"],
        "down_w": _t(sd["vis_proj.0.weight"]),  # torch (r, D) -> (D, r)
        "up_w": _t(sd["vis_proj.1.weight"]),  # torch (D, r) -> (r, D)
    }


def convert_checkpoint(
    sd: Dict[str, np.ndarray], cfg: PaDTConfig, dtype=None, device="cpu"
) -> Dict[str, Any]:
    """Full state dict -> PaDT param tree of torch tensors on `device`
    (floating leaves cast to `dtype` when it is given). Missing PaDT extras
    (plain Qwen2.5-VL checkpoints) are zero/random-initialized by the caller."""
    sd = normalize_keys(sd)
    params: Dict[str, Any] = {
        "vision": convert_vision(sd, cfg.vision),
        "text": convert_text(sd, cfg.text),
    }
    if any(k.startswith("vl_decoder.") for k in sd):
        params["decoder"] = convert_decoder(sd, cfg.decoder)
    proto = convert_proto(sd)
    if proto is not None:
        params["proto"] = proto

    def to_torch(tree):
        return {k: to_torch(v) if isinstance(v, dict) else safetensors_io.to_torch(v, device, dtype)
                for k, v in tree.items()}

    return to_torch(params)


def config_from_hf(hf_config: Dict[str, Any]) -> PaDTConfig:
    """Build a PaDTConfig from an HF config.json dict (PaDT or stock
    Qwen2.5-VL); mirrors how the reference stores `vl_decoder` inside the HF
    config (`padt_sft_trainer.py:149-162`)."""
    vc = hf_config["vision_config"]
    tc = hf_config.get("text_config", hf_config)
    vision = VisionConfig(
        depth=vc.get("depth", 32),
        hidden_size=vc.get("hidden_size", 1280),
        intermediate_size=vc.get("intermediate_size", 3420),
        num_heads=vc.get("num_heads", 16),
        patch_size=vc.get("patch_size", 14),
        temporal_patch_size=vc.get("temporal_patch_size", 2),
        spatial_merge_size=vc.get("spatial_merge_size", 2),
        out_hidden_size=vc.get("out_hidden_size", vc.get("hidden_size", 1280)),
        window_size=vc.get("window_size", 112),
        fullatt_block_indexes=tuple(vc.get("fullatt_block_indexes", (7, 15, 23, 31))),
    )
    rope_scaling = tc.get("rope_scaling") or {}
    text = TextConfig(
        vocab_size=tc["vocab_size"],
        hidden_size=tc["hidden_size"],
        num_hidden_layers=tc["num_hidden_layers"],
        num_attention_heads=tc["num_attention_heads"],
        num_key_value_heads=tc["num_key_value_heads"],
        head_dim=tc.get("head_dim") or tc["hidden_size"] // tc["num_attention_heads"],
        intermediate_size=tc["intermediate_size"],
        rms_norm_eps=tc.get("rms_norm_eps", 1e-6),
        rope_theta=tc.get("rope_theta", 1_000_000.0),
        mrope_section=tuple(rope_scaling.get("mrope_section", (16, 24, 24))),
        tie_word_embeddings=hf_config.get("tie_word_embeddings", tc.get("tie_word_embeddings", False)),
    )
    vd = hf_config.get("vl_decoder", {})
    decoder = DecoderConfig(
        hidden_size=vd.get("hidden_size", 1280),
        intermediate_size=vd.get("intermediate_size", 3420),
        num_heads=vd.get("num_heads", 16),
        llm_hidden_size=tc["hidden_size"],
        spatial_merge_size=vd.get("spatial_merge_size", vision.spatial_merge_size),
        use_mask_head=vd.get("use_mask_loss", True),
    )
    return PaDTConfig(
        vision=vision,
        text=text,
        decoder=decoder,
        use_visual_prototype_projection=hf_config.get("use_visual_prototype_projection", True),
        image_token_id=hf_config.get("image_token_id", 151655),
        video_token_id=hf_config.get("video_token_id", 151656),
        vision_start_token_id=hf_config.get("vision_start_token_id", 151652),
        eos_token_id=hf_config.get("eos_token_id", 151645),
        pad_token_id=hf_config.get("pad_token_id") or 151643,
    )


def load_padt_checkpoint(path: str, dtype=None, device="cpu", **config_overrides):
    """Load an HF-format PaDT (or Qwen2.5-VL) checkpoint directory."""
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = config_from_hf(hf_cfg)
    if config_overrides:
        cfg = cfg.replace(**config_overrides)
    sd = load_safetensors_dir(path)
    params = convert_checkpoint(sd, cfg, dtype=dtype, device=device)
    return cfg, params
