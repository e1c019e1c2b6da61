"""Configuration tree for PaDT (the port's copy of `padt_tpu/config.py`,
field for field the same, so `PaDTConfig.from_json(other.to_json())` moves a
config between the two packages). The port's own `TextConfig` fields for a
sparse-expert text stack (`num_experts` and the rest of `_TEXT_OPTIONAL`)
serialise only where they are set, so a dense config still moves.

Single source of truth for model / decoder / runtime configuration, mirroring the
capability surface of the reference (Gorilla-Lab-SCUT/PaDT):
  - vl_decoder config dict injected by the trainer (reference
    `src/PaDT/trainer/padt_sft_trainer.py:149-162`),
  - Qwen2.5-VL model configs (3B / 7B presets),
  - the "model carries its decoder config" property (reference stores `vl_decoder`
    inside the HF config; we persist `PaDTConfig` in checkpoint metadata).

All shapes that are dynamic in the reference (image patches, #objects, #VRTs per
object) are bucketed/padded here so XLA sees static shapes.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class VisionConfig:
    """Qwen2.5-VL vision tower (reference: transformers Qwen2_5_VLVisionConfig)."""

    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    out_hidden_size: int = 2048
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    rms_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def spatial_merge_unit(self) -> int:
        return self.spatial_merge_size * self.spatial_merge_size

    @property
    def patch_input_dim(self) -> int:
        # flattened (temporal_patch, C, patch, patch) input per token
        return self.in_channels * self.temporal_patch_size * self.patch_size * self.patch_size


@dataclass(frozen=True)
class TextConfig:
    """Qwen2.5 text decoder with M-RoPE (reference: Qwen2_5_VLTextConfig)."""

    vocab_size: int = 151936  # embedding-table size (== model_embed_token_size)
    hidden_size: int = 2048
    num_hidden_layers: int = 36
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    head_dim: int = 128
    intermediate_size: int = 11008
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    mrope_section: Tuple[int, int, int] = (16, 24, 24)
    tie_word_embeddings: bool = True
    attention_bias: bool = True  # Qwen2.5 uses bias on q/k/v projections
    # sparse experts (Qwen3-MoE's keys): 0 experts is the dense SwiGLU MLP
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = False  # renormalise the chosen experts' probabilities to sum to 1
    qk_norm: bool = False  # RMSNorm over head_dim on each q and k head before rope (Qwen3)
    sa_topk: int = 0  # keys a sparse-attention indexer keeps (0: none); the port has no indexer


# TextConfig fields that serialise only where they differ from their defaults,
# so a dense config's JSON is what it was before they existed
_TEXT_OPTIONAL = ("num_experts", "num_experts_per_tok", "moe_intermediate_size", "norm_topk_prob", "qk_norm", "sa_topk")


def text_opt(tc, name: str):
    """A `_TEXT_OPTIONAL` field of a text config, or its default where the
    config has no such field (the JAX package's `TextConfig`, which some
    callers hand to the port)."""
    return getattr(tc, name, getattr(TextConfig, name))


@dataclass(frozen=True)
class DecoderConfig:
    """PaDT perception decoder (reference `padt_decoder.py:131-186`,
    trainer-injected dict `padt_sft_trainer.py:151-160`)."""

    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    llm_hidden_size: int = 2048  # overwritten with text hidden size (padt.py:130)
    spatial_merge_size: int = 2
    use_mask_head: bool = True  # reference `use_mask_loss`
    rms_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class PaDTConfig:
    """Top-level PaDT model config.

    Mirrors PaDTForConditionalGeneration config surface (reference `padt.py:114-132`):
    vis_norm/vis_proj prototype projection toggle, decoder config, special tokens.
    """

    vision: VisionConfig = field(default_factory=VisionConfig)
    text: TextConfig = field(default_factory=TextConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)

    use_visual_prototype_projection: bool = True
    prototype_proj_rank: int = 64  # reference `lora_r = 64` (padt.py:120)

    # special token ids (Qwen2.5-VL)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    eos_token_id: int = 151645  # <|im_end|>
    pad_token_id: int = 151643  # <|endoftext|>

    # static-shape buckets (TPU-specific; no reference equivalent — the reference
    # uses dynamic shapes on GPU)
    max_image_patches: int = 2304  # 14px-patch tokens per image, multiple of 4
    max_vrt_per_object: int = 16
    max_objects: int = 32
    # process the vision tower in batch chunks of this size (0 = whole batch):
    # bounds activation transients so large serving batches fit in HBM
    vision_chunk_size: int = 0

    dtype: str = "bfloat16"

    @property
    def max_merged_patches(self) -> int:
        return self.max_image_patches // self.vision.spatial_merge_unit

    def replace(self, **kw) -> "PaDTConfig":
        return dataclasses.replace(self, **kw)

    # ----- serialization (checkpoint metadata carries the config) -----
    def to_json(self) -> str:
        def enc(o):
            if dataclasses.is_dataclass(o):
                return {k: enc(v) for k, v in dataclasses.asdict(o).items()}
            return o
        d = enc(self)
        default = TextConfig()
        for k in _TEXT_OPTIONAL:
            if d["text"][k] == getattr(default, k):
                del d["text"][k]
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "PaDTConfig":
        d = json.loads(s)
        return PaDTConfig(
            vision=VisionConfig(**{**d["vision"], "fullatt_block_indexes": tuple(d["vision"]["fullatt_block_indexes"])}),
            text=TextConfig(**{**d["text"], "mrope_section": tuple(d["text"]["mrope_section"])}),
            decoder=DecoderConfig(**d["decoder"]),
            **{k: v for k, v in d.items() if k not in ("vision", "text", "decoder")},
        )


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

def padt_3b() -> PaDTConfig:
    """PaDT on Qwen2.5-VL-3B-Instruct (reference README.md:148-157)."""
    return PaDTConfig()


def padt_7b() -> PaDTConfig:
    """PaDT on Qwen2.5-VL-7B-Instruct."""
    return PaDTConfig(
        vision=VisionConfig(out_hidden_size=3584),
        text=TextConfig(
            vocab_size=152064,
            hidden_size=3584,
            num_hidden_layers=28,
            num_attention_heads=28,
            num_key_value_heads=4,
            intermediate_size=18944,
            tie_word_embeddings=False,
        ),
        decoder=DecoderConfig(llm_hidden_size=3584),
    )


def padt_tiny(vocab_size: int = 1024) -> PaDTConfig:
    """Tiny config for CPU tests: same code paths, small dims."""
    return PaDTConfig(
        vision=VisionConfig(
            depth=4,
            hidden_size=64,
            intermediate_size=128,
            num_heads=4,
            out_hidden_size=96,
            fullatt_block_indexes=(1, 3),
        ),
        text=TextConfig(
            vocab_size=vocab_size,
            hidden_size=96,
            num_hidden_layers=4,
            num_attention_heads=4,
            num_key_value_heads=2,
            head_dim=32,
            intermediate_size=160,
            mrope_section=(4, 6, 6),
        ),
        decoder=DecoderConfig(hidden_size=64, intermediate_size=128, num_heads=4, llm_hidden_size=96),
        image_token_id=vocab_size - 10,
        video_token_id=vocab_size - 9,
        vision_start_token_id=vocab_size - 12,
        eos_token_id=vocab_size - 1,
        pad_token_id=vocab_size - 2,
        max_image_patches=256,
        max_vrt_per_object=8,
        max_objects=8,
    )
