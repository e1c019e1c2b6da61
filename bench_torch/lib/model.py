"""A configuration file -> the program's config, its processor and its
inference engine over the seeded weights.

The program (`padt_tpu_torch`) is imported here and in the loops; the
yardstick (traffic, inputs, weights, counts, trace reading, reference,
check) does not.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from . import inputs


def _fill(cls, keys: Dict):
    """`cls` with each field that `keys` names set from it (lists as
    tuples); the fields it does not name keep the program's defaults."""
    known = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in keys.items() if k in known})


def port_config(model: Dict):
    """The program's `PaDTConfig` with the file's numbers: `TextConfig` and
    `PaDTConfig`'s own fields from the top-level keys of the same names,
    `VisionConfig` from `vision_config` (its `in_chans` is `in_channels`),
    `DecoderConfig` from `decoder_config` (at the text's `hidden_size`)."""
    from padt_tpu_torch.config import DecoderConfig, PaDTConfig, TextConfig, VisionConfig

    vision = dict(model["vision_config"])
    vision["in_channels"] = vision.pop("in_chans")
    parts = {
        "vision": _fill(VisionConfig, vision),
        "text": _fill(TextConfig, model),
        "decoder": _fill(DecoderConfig, dict(model["decoder_config"], llm_hidden_size=model["hidden_size"])),
    }
    return _fill(PaDTConfig, {**model, **parts})


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
