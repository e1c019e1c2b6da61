"""PaDT param tree -> HF (PyTorch safetensors) checkpoint exporter (the
port's copy of `padt_tpu/convert/padt_to_hf.py`: torch leaves leave through
one device-to-host copy each, and the files are written by the port's own
`safetensors_io`, bf16 as bf16).

Reverse of `hf_to_padt.py`: emits the 4.50-era canonical key layout
(`visual.*`, `model.*`, `lm_head.*`, `vl_decoder.*`, `vis_norm.*`,
`vis_proj.*`) that released PaDT checkpoints use, so a trained PaDT-TPU
model round-trips into the reference's deployment format — the property the
reference gets from DeepSpeed's `stage3_gather_16bit_weights_on_model_save`
(`local_scripts/zero3.json:32`) + `trainer.save_model` (`sft_train.py:112`).

Exported tensors keep the tree's dtype (bf16 params -> bf16 safetensors,
matching the reference's 16-bit gather) unless `dtype` is given.

Caveat: stock transformers (>=4.52) hardcodes text head_dim to
hidden_size // num_attention_heads for Qwen2.5-VL, so a config with a
decoupled head_dim exports fine and round-trips through this package's
loader, but cannot be re-instantiated by transformers itself. All released
PaDT/Qwen2.5-VL checkpoints are consistent (3B: 2048/16=128), so this only
affects synthetic test configs.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

from . import safetensors_io


def _np(x, dtype=None) -> np.ndarray:
    a = np.asarray(x)
    if dtype is not None:
        a = a.astype(dtype)
    return np.ascontiguousarray(a)


def _t(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x).T)


def _unlin(out: Dict[str, np.ndarray], prefix: str, p: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = _t(p["w"])  # (in, out) -> torch (out, in)
    if "b" in p:
        out[f"{prefix}.bias"] = _np(p["b"])


def export_vision(params: Dict[str, Any], cfg) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    pe = _t(params["patch_embed"]["w"])  # (D, C*tP*P*P)
    out["visual.patch_embed.proj.weight"] = pe.reshape(
        pe.shape[0], cfg.in_channels, cfg.temporal_patch_size, cfg.patch_size, cfg.patch_size
    )
    out["visual.merger.ln_q.weight"] = _np(params["merger"]["ln_q_w"])
    _unlin(out, "visual.merger.mlp.0", params["merger"]["fc1"])
    _unlin(out, "visual.merger.mlp.2", params["merger"]["fc2"])

    blocks = params["blocks"]
    for i in range(cfg.depth):
        p = f"visual.blocks.{i}"
        out[f"{p}.norm1.weight"] = _np(blocks["norm1_w"][i])
        out[f"{p}.norm2.weight"] = _np(blocks["norm2_w"][i])
        out[f"{p}.attn.qkv.weight"] = _t(blocks["qkv_w"][i])
        out[f"{p}.attn.qkv.bias"] = _np(blocks["qkv_b"][i])
        out[f"{p}.attn.proj.weight"] = _t(blocks["proj_w"][i])
        out[f"{p}.attn.proj.bias"] = _np(blocks["proj_b"][i])
        for name, wk, bk in (
            ("gate_proj", "gate_w", "gate_b"),
            ("up_proj", "up_w", "up_b"),
            ("down_proj", "down_w", "down_b"),
        ):
            out[f"{p}.mlp.{name}.weight"] = _t(blocks[wk][i])
            out[f"{p}.mlp.{name}.bias"] = _np(blocks[bk][i])
    return out


def export_text(params: Dict[str, Any], cfg) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {
        "model.embed_tokens.weight": _np(params["embed"]),
        "model.norm.weight": _np(params["final_ln_w"]),
    }
    if not cfg.tie_word_embeddings and "lm_head" in params:
        out["lm_head.weight"] = _np(params["lm_head"])
    layers = params["layers"]
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        out[f"{p}.input_layernorm.weight"] = _np(layers["input_ln_w"][i])
        out[f"{p}.post_attention_layernorm.weight"] = _np(layers["post_ln_w"][i])
        for proj, wk, bk in (
            ("q_proj", "q_w", "q_b"),
            ("k_proj", "k_w", "k_b"),
            ("v_proj", "v_w", "v_b"),
        ):
            out[f"{p}.self_attn.{proj}.weight"] = _t(layers[wk][i])
            out[f"{p}.self_attn.{proj}.bias"] = _np(layers[bk][i])
        out[f"{p}.self_attn.o_proj.weight"] = _t(layers["o_w"][i])
        for proj, wk in (("gate_proj", "gate_w"), ("up_proj", "up_w"), ("down_proj", "down_w")):
            out[f"{p}.mlp.{proj}.weight"] = _t(layers[wk][i])
    return out


def _unattn(out: Dict[str, np.ndarray], prefix: str, p: Dict[str, Any]) -> None:
    _unlin(out, f"{prefix}.q_proj", p["q"])
    _unlin(out, f"{prefix}.k_proj", p["k"])
    _unlin(out, f"{prefix}.v_proj", p["v"])
    _unlin(out, f"{prefix}.proj", p["o"])


def _unblock(out: Dict[str, np.ndarray], prefix: str, p: Dict[str, Any]) -> None:
    for i in range(1, 7):
        out[f"{prefix}.norm{i}.weight"] = _np(p[f"norm{i}_w"])
    _unattn(out, f"{prefix}.self_attn", p["self_attn"])
    _unattn(out, f"{prefix}.cross_attn_query_to_image", p["cross_q2i"])
    _unattn(out, f"{prefix}.cross_attn_image_to_query", p["cross_i2q"])
    _unlin(out, f"{prefix}.mlp.0", p["mlp_fc1"])
    _unlin(out, f"{prefix}.mlp.2", p["mlp_fc2"])


def export_decoder(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    p = "vl_decoder"
    out: Dict[str, np.ndarray] = {
        f"{p}.vp_embedding.weight": _np(params["vp_embedding"])[None],
        f"{p}.bbox_score_mask_tokens.weight": _np(params["bbox_score_mask_tokens"]),
        f"{p}.input_projection.0.weight": _np(params["input_proj"]["norm_w"]),
        f"{p}.high_res_norm.weight": _np(params["high_res_norm_w"]),
    }
    _unlin(out, f"{p}.input_projection.1", params["input_proj"]["fc1"])
    _unlin(out, f"{p}.input_projection.3", params["input_proj"]["fc2"])
    _unblock(out, f"{p}.low_res_transformer", params["low_res"])
    _unblock(out, f"{p}.high_res_transformer1", params["high_res1"])
    _unblock(out, f"{p}.high_res_transformer2", params["high_res2"])
    _unlin(out, f"{p}.bbox_prediction.0", params["bbox_fc1"])
    _unlin(out, f"{p}.bbox_prediction.2", params["bbox_fc2"])
    _unlin(out, f"{p}.bbox_prediction.4", params["bbox_fc3"])
    _unlin(out, f"{p}.score_prediction", params["score"])
    up1 = params["mask_up1"]
    _unlin(out, f"{p}.mask_output_upscaling1.0", {k: up1[k] for k in ("w", "b") if k in up1})
    out[f"{p}.mask_output_upscaling1.1.weight"] = _np(up1["norm_w"])
    _unlin(out, f"{p}.mask_output_upscaling2.0", params["mask_up2"])
    _unlin(out, f"{p}.mask_output_mlp.0", params["mask_mlp_fc1"])
    _unlin(out, f"{p}.mask_output_mlp.2", params["mask_mlp_fc2"])
    _unlin(out, f"{p}.mask_output_mlp.4", params["mask_mlp_fc3"])
    return out


def export_proto(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {
        "vis_norm.weight": _np(params["ln_w"]),
        "vis_norm.bias": _np(params["ln_b"]),
        "vis_proj.0.weight": _t(params["down_w"]),  # (D, r) -> torch (r, D)
        "vis_proj.1.weight": _t(params["up_w"]),  # (r, D) -> torch (D, r)
    }


def export_state_dict(params: Dict[str, Any], cfg) -> Dict[str, np.ndarray]:
    """Param pytree -> flat HF state dict (4.50-era canonical keys)."""
    sd: Dict[str, np.ndarray] = {}
    sd.update(export_vision(params["vision"], cfg.vision))
    sd.update(export_text(params["text"], cfg.text))
    if "decoder" in params:
        sd.update(export_decoder(params["decoder"]))
    if "proto" in params:
        sd.update(export_proto(params["proto"]))
    return sd


def hf_config_from_padt(cfg) -> Dict[str, Any]:
    """PaDTConfig -> HF config.json dict; inverse of
    `hf_to_padt.config_from_hf` (fields it reads are all present)."""
    v, t, d = cfg.vision, cfg.text, cfg.decoder
    return {
        "architectures": ["PaDTForConditionalGeneration"],
        "model_type": "qwen2_5_vl",
        "vision_config": {
            "depth": v.depth,
            "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size,
            "num_heads": v.num_heads,
            "in_channels": v.in_channels,
            "patch_size": v.patch_size,
            "temporal_patch_size": v.temporal_patch_size,
            "spatial_merge_size": v.spatial_merge_size,
            "out_hidden_size": v.out_hidden_size,
            "window_size": v.window_size,
            "fullatt_block_indexes": list(v.fullatt_block_indexes),
        },
        "text_config": {
            "vocab_size": t.vocab_size,
            "hidden_size": t.hidden_size,
            "num_hidden_layers": t.num_hidden_layers,
            "num_attention_heads": t.num_attention_heads,
            "num_key_value_heads": t.num_key_value_heads,
            "head_dim": t.head_dim,
            "intermediate_size": t.intermediate_size,
            "rms_norm_eps": t.rms_norm_eps,
            "rope_theta": t.rope_theta,
            "rope_scaling": {"type": "mrope", "mrope_section": list(t.mrope_section)},
        },
        "vl_decoder": {
            "name": "PaDTDecoder",
            "hidden_size": d.hidden_size,
            "intermediate_size": d.intermediate_size,
            "num_heads": d.num_heads,
            "llm_hidden_state": d.llm_hidden_size,
            "spatial_merge_size": d.spatial_merge_size,
            "use_mask_loss": d.use_mask_head,
            "attn_implementation": "flash_attention_2",
        },
        "use_visual_prototype_projection": cfg.use_visual_prototype_projection,
        "tie_word_embeddings": t.tie_word_embeddings,
        "image_token_id": cfg.image_token_id,
        "video_token_id": cfg.video_token_id,
        "vision_start_token_id": cfg.vision_start_token_id,
        "eos_token_id": cfg.eos_token_id,
    }


def save_hf_checkpoint(
    path: str,
    params: Dict[str, Any],
    cfg,
    dtype=None,
    shard_size: int = 4 * 1024**3,
) -> None:
    """Write config.json + model*.safetensors (sharded above `shard_size`
    bytes, with the HF weight index). Torch leaves are copied to the host
    once each (cast to the torch `dtype` first when it is given); bf16 stays
    bf16 on disk."""
    os.makedirs(path, exist_ok=True)

    def host(tree):
        return {k: host(v) if isinstance(v, dict) else safetensors_io.from_torch(v if dtype is None else v.to(dtype))
                for k, v in tree.items()}

    sd = export_state_dict(host(params), cfg)

    total = sum(v.nbytes for v in sd.values())
    if total <= shard_size:
        safetensors_io.save_file(sd, os.path.join(path, "model.safetensors"))
    else:
        shards, cur, cur_bytes = [], {}, 0
        for k, v in sd.items():
            if cur and cur_bytes + v.nbytes > shard_size:
                shards.append(cur)
                cur, cur_bytes = {}, 0
            cur[k] = v
            cur_bytes += v.nbytes
        shards.append(cur)
        n = len(shards)
        index = {"metadata": {"total_size": total}, "weight_map": {}}
        for i, shard in enumerate(shards):
            fname = f"model-{i + 1:05d}-of-{n:05d}.safetensors"
            safetensors_io.save_file(shard, os.path.join(path, fname))
            for k in shard:
                index["weight_map"][k] = fname
        with open(os.path.join(path, safetensors_io.INDEX_NAME), "w") as f:
            json.dump(index, f, indent=2)

    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_from_padt(cfg), f, indent=2)
