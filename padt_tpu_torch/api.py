"""High-level user API (the port's counterpart of `padt_tpu/api.py`): the
equivalents of the reference's public surface
(`PaDTForConditionalGeneration.from_pretrained` + `AutoProcessor` +
`VisonTextProcessingClass`, see `eval/test_demo.py:20-31`).

`load_model(path)` loads an HF-format PaDT (or stock Qwen2.5-VL) checkpoint
directory (config.json with its embedded vl_decoder dict, safetensors
weights, the tokenizer), or a native one (`padt_config.json` + `params.pt`,
written by `tools/convert_checkpoint.py`, or a trainer checkpoint's
`meta.json` + `state.pt`), and returns (cfg, params, processor) with the
params as torch tensors on a device, ready for the inference harness or
the trainer. JAX's orbax branch has no counterpart: the native format is
`torch.save`'s.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from .config import PaDTConfig
from .vrt.processor import VisionTextProcessor

NATIVE_CONFIG, NATIVE_PARAMS = "padt_config.json", "params.pt"


def load_tokenizer(model_path: str):
    """HF tokenizer from a local checkpoint dir (pure data dep; None when
    there is none, and the caller falls back to the offline mock for
    random-weight demos). A directory with no tokenizer or vocab file has
    none: `transformers` is then not imported at all (its import takes
    seconds)."""
    if os.path.isdir(model_path) and not any("tokenizer" in f or "vocab" in f for f in os.listdir(model_path)):
        return None
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(model_path, trust_remote_code=False)
    except Exception:
        return None


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def load_native(model_path: str, device="cuda") -> Tuple[PaDTConfig, Dict[str, Any]]:
    """A native checkpoint dir -> (cfg, params on `device`), the saved dtypes
    kept: `padt_config.json` + `params.pt`, or a `PaDTTrainer` checkpoint
    (`meta.json` with the config, `state.pt` with the parameters)."""
    if os.path.exists(os.path.join(model_path, NATIVE_CONFIG)):
        with open(os.path.join(model_path, NATIVE_CONFIG)) as f:
            cfg = PaDTConfig.from_json(f.read())
        params = torch.load(os.path.join(model_path, NATIVE_PARAMS), map_location=device, weights_only=True)
    else:
        with open(os.path.join(model_path, "meta.json")) as f:
            cfg = PaDTConfig.from_json(json.dumps(json.load(f)["config"]))
        params = torch.load(os.path.join(model_path, "state.pt"), map_location=device, weights_only=True)["params"]
    return cfg, params


def save_native(path: str, cfg: PaDTConfig, params: Dict[str, Any]) -> None:
    """Write the native format: `padt_config.json` + `params.pt`."""
    os.makedirs(path, exist_ok=True)
    torch.save(_map_tree(lambda t: t.detach(), params), os.path.join(path, NATIVE_PARAMS))
    with open(os.path.join(path, NATIVE_CONFIG), "w") as f:
        f.write(cfg.to_json())


def is_native(model_path: str) -> bool:
    return any(os.path.exists(os.path.join(model_path, f)) for f in (NATIVE_CONFIG, "state.pt"))


def load_model(
    model_path: str,
    dtype: Optional[torch.dtype] = None,
    min_pixels: int = 3136,
    max_pixels: int = 12_845_056,
    use_mask_head: Optional[bool] = True,
    device="cuda",
    **config_overrides,
) -> Tuple[PaDTConfig, Any, VisionTextProcessor]:
    """Checkpoint dir -> (cfg, params, processor).

    Mirrors `eval/evaluation_scripts/utils.py:57-84` (load_model) minus the
    DeepSpeed engine: params are plain torch tensors on `device`, floating
    leaves of an HF checkpoint cast to `dtype` (default bfloat16; a native
    checkpoint keeps its saved dtypes). `use_mask_head=True` replicates the eval-time
    `config.vl_decoder['use_mask_loss'] = True` (utils.py:59).
    """
    from .convert.hf_to_padt import load_padt_checkpoint

    dtype = dtype if dtype is not None else torch.bfloat16
    if is_native(model_path):
        cfg, params = load_native(model_path, device)
        if config_overrides:
            cfg = cfg.replace(**config_overrides)
    else:
        cfg, params = load_padt_checkpoint(model_path, dtype=dtype, device=device, **config_overrides)
    if use_mask_head is not None:
        cfg = cfg.replace(decoder=dataclasses.replace(cfg.decoder, use_mask_head=use_mask_head))

    # PaDT extras may be absent in stock Qwen2.5-VL checkpoints -> random init
    # from a seeded generator (JAX draws them from PRNGKey(0): other values)
    if "decoder" not in params or ("proto" not in params and cfg.use_visual_prototype_projection):
        from .models.decoder import init_decoder_params
        from .models.padt import init_proto_params

        g = torch.Generator(device=device).manual_seed(0)
        dt = params["text"]["embed"].dtype
        if "decoder" not in params:
            params["decoder"] = init_decoder_params(cfg.decoder, g, device, dt)
        if cfg.use_visual_prototype_projection and "proto" not in params:
            params["proto"] = init_proto_params(cfg, g, device, dt)

    tokenizer = load_tokenizer(model_path)
    if tokenizer is None:
        from .utils.mock_tokenizer import make_tiny_tokenizer

        tokenizer = make_tiny_tokenizer(cfg)
    processor = VisionTextProcessor(tokenizer, cfg, min_pixels=min_pixels, max_pixels=max_pixels)
    processor.prepare(params["text"]["embed"].shape[0])
    return cfg, params, processor
