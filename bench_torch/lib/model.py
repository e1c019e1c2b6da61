"""A configuration file -> the program's config, its processor and its
inference engine over the seeded weights.

The program (`padt_tpu_torch`) is imported here and in the loops; the
yardstick (traffic, inputs, weights, counts, trace reading, reference,
check) does not.
"""

from __future__ import annotations

from typing import Dict

from . import inputs


def port_config(model: Dict, **overrides):
    """The program's `PaDTConfig` with the file's numbers."""
    from padt_tpu_torch.config import DecoderConfig, PaDTConfig, TextConfig, VisionConfig

    vc, dc = model["vision_config"], model["decoder_config"]
    return PaDTConfig(
        vision=VisionConfig(
            depth=vc["depth"], hidden_size=vc["hidden_size"], intermediate_size=vc["intermediate_size"],
            num_heads=vc["num_heads"], in_channels=vc["in_chans"], patch_size=vc["patch_size"],
            temporal_patch_size=vc["temporal_patch_size"], spatial_merge_size=vc["spatial_merge_size"],
            out_hidden_size=vc["out_hidden_size"], window_size=vc["window_size"],
            fullatt_block_indexes=tuple(vc["fullatt_block_indexes"]), rms_norm_eps=vc["rms_norm_eps"],
        ),
        text=TextConfig(
            vocab_size=model["vocab_size"], hidden_size=model["hidden_size"],
            num_hidden_layers=model["num_hidden_layers"], num_attention_heads=model["num_attention_heads"],
            num_key_value_heads=model["num_key_value_heads"], head_dim=model["head_dim"],
            intermediate_size=model["intermediate_size"], rms_norm_eps=model["rms_norm_eps"],
            rope_theta=model["rope_theta"], mrope_section=tuple(model["mrope_section"]),
            tie_word_embeddings=model["tie_word_embeddings"],
        ),
        decoder=DecoderConfig(
            hidden_size=dc["hidden_size"], intermediate_size=dc["intermediate_size"], num_heads=dc["num_heads"],
            llm_hidden_size=model["hidden_size"], spatial_merge_size=dc["spatial_merge_size"],
            use_mask_head=dc["use_mask_head"],
        ),
        prototype_proj_rank=model["prototype_proj_rank"],
        image_token_id=model["image_token_id"], video_token_id=model["video_token_id"],
        vision_start_token_id=model["vision_start_token_id"], eos_token_id=model["eos_token_id"],
        pad_token_id=model["pad_token_id"], max_image_patches=model["max_image_patches"],
        max_vrt_per_object=model["max_vrt_per_object"], max_objects=model["max_objects"],
        **overrides,
    )


def processor(cfg):
    """The program's processor over its offline mock tokenizer, with one
    change of the benchmark's: prompt text is split into words and
    punctuation, one token each (an id hashed from the piece), instead of
    one token per character. That gives the prompt about the token count of
    Qwen's BPE (the REC prompt's text is some 40 tokens, not some 150);
    special tokens and the decoding of served tokens are the mock's."""
    from padt_tpu_torch.utils.mock_tokenizer import make_full_tokenizer
    from padt_tpu_torch.vrt.processor import VisionTextProcessor

    tok = make_full_tokenizer(cfg)
    # words hash into ids above the mock's 256 character ids and below every special token
    hi = min(cfg.vision_start_token_id, cfg.image_token_id, cfg.video_token_id, cfg.pad_token_id, cfg.eos_token_id)
    tok.encode = lambda text, add_special_tokens=False: inputs.encode(text, tok._vocab, hi)
    proc = VisionTextProcessor(tok, cfg)
    proc.prepare(cfg.text.vocab_size)
    return proc


def engine(weights: Dict, cfg, proc, max_new_tokens: int):
    """The program's `InferenceEngine` over the seeded tree."""
    from padt_tpu_torch.eval.harness import InferenceEngine

    return InferenceEngine(weights, cfg, proc, max_new_tokens=max_new_tokens)
