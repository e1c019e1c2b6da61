"""Vision-text processor: tokenizer wrapper + dynamic VRT vocabulary + batch construction
(the port's copy of `padt_tpu/vrt/processor.py`).

Rebuilds `VisonTextProcessingClass` (reference `padt_processor.py:4-57`):
  - `prepare(model_embed_size)` pads the tokenizer with `<|empty_token_i|>`
    specials so VRT ids start exactly at the embed-table size
    (`padt_processor.py:15-21`),
  - lazy `<|VRT_i|>` vocabulary growth per image size (`padt_processor.py:23-34`),
  - `pid2vrt` patch-id -> token-string rendering (`padt_processor.py:52-57`),
  - `assign_to_{global,local}_vrt_id` kept for API parity but are IDENTITY here:
    the TPU model uses per-sample prototype tables, so VRT ids are always local
    (`vocab_size + patch_id`) — the reference needed the global shift only
    because it packs all images' prototypes into one table
    (`padt_processor.py:36-50`, SURVEY.md §7).

Also owns batch construction: chat templating, `<|image_pad|>` expansion, static
bucketing, vision geometry, and M-RoPE position ids — everything the jitted
model consumes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import PaDTConfig
from ..models.mrope_index import get_rope_index
from ..models.vision_geom import vision_geometry
from ..preprocess.vision_process import ProcessedImage, process_image

CHAT_TEMPLATE = (
    "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
    "<|im_start|>user\n{content}<|im_end|>\n"
    "<|im_start|>assistant\n"
)
IMAGE_CONTENT = "<|vision_start|><|image_pad|><|vision_end|>"
VIDEO_CONTENT = "<|vision_start|><|video_pad|><|vision_end|>"


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class Batch:
    """Numpy batch; `model_inputs()` yields exactly the jitted-model kwargs."""

    data: Dict[str, np.ndarray]
    rope_deltas: np.ndarray
    prompt_length: int

    def model_inputs(self) -> Dict[str, np.ndarray]:
        return self.data


class VisionTextProcessor:
    def __init__(
        self,
        tokenizer,
        cfg: PaDTConfig,
        min_pixels: int = 3136,
        max_pixels: int = 12_845_056,
        seq_bucket: int = 64,
        patch_bucket: int = 256,
        u8_pixels: bool = False,
    ):
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        self.seq_bucket = seq_bucket
        self.patch_bucket = patch_bucket
        # compact uint8 pixel wire format for raw images handed to
        # build_batch (serving/eval default via InferenceEngine): 4x fewer
        # host<->device bytes; expansion is bitwise-equal inside the vision
        # jit (models/padt.py::_expand_pixels_u8)
        self.u8_pixels = u8_pixels
        self.model_embed_token_size = cfg.text.vocab_size
        self._num_vrt_tokens = 0

    # ------------------------------------------------------------------
    # reference-parity tokenizer surface
    # ------------------------------------------------------------------
    def prepare(self, model_embed_token_size: int) -> bool:
        """Pad tokenizer with empty specials up to the embed-table size
        (padt_processor.py:15-21)."""
        self.model_embed_token_size = model_embed_token_size
        need = model_embed_token_size - len(self.tokenizer.get_vocab())
        if need > 0:
            self.tokenizer.add_tokens([f"<|empty_token_{i}|>" for i in range(need)], special_tokens=True)
        assert len(self.tokenizer.get_vocab()) >= model_embed_token_size
        return True

    def ensure_vrt_tokens(self, max_merged_patches: int) -> None:
        """Lazily add `<|VRT_i|>` so ids land at vocab_size + i
        (padt_processor.py:23-28)."""
        have = len(self.tokenizer.get_vocab()) - self.model_embed_token_size
        if have < max_merged_patches:
            self.tokenizer.add_tokens(
                [f"<|VRT_{i}|>" for i in range(max(have, 0), max_merged_patches)],
                special_tokens=False,
            )
            self._num_vrt_tokens = max_merged_patches

    def set_image_grid_thw(self, image_grid_thw) -> bool:
        grid = np.asarray(image_grid_thw)
        max_m = int((grid.prod(axis=-1) // self.cfg.vision.spatial_merge_unit).max())
        self.ensure_vrt_tokens(max_m)
        return True

    def pid2vrt(self, patch_ids) -> str:
        if isinstance(patch_ids, (int, np.integer)):
            patch_ids = [patch_ids]
        return "".join(f"<|VRT_{int(i)}|>" for i in patch_ids)

    def assign_to_global_vrt_id(self, input_ids, image_grid_thw=None):
        """Identity: per-sample prototype tables mean local ids ARE the model's
        ids (see module docstring)."""
        return input_ids

    def assign_to_local_vrt_id(self, input_ids, image_grid_thw=None):
        """Identity (see assign_to_global_vrt_id)."""
        return input_ids

    # ------------------------------------------------------------------
    # templating / tokenization
    # ------------------------------------------------------------------
    def apply_chat_template(self, prompt: str, has_image: bool = True, is_video: bool = False) -> str:
        vis = (VIDEO_CONTENT if is_video else IMAGE_CONTENT) if has_image else ""
        return CHAT_TEMPLATE.format(content=vis + prompt)

    def encode(self, text: str) -> List[int]:
        return self.tokenizer.encode(text, add_special_tokens=False)

    def token_strings(self, ids: Sequence[int]) -> List[str]:
        """Per-token decoded strings (the parser's input; reference
        batch_decode-per-token, padt_processor.py:76)."""
        return self.tokenizer.batch_decode([[int(i)] for i in ids])

    # ------------------------------------------------------------------
    # prefix/suffix splitting (serve-engine prefix KV caching)
    # ------------------------------------------------------------------
    def build_prefix_batch(
        self,
        image,
        prefix_bucket: Optional[int] = None,
        patch_bucket: Optional[int] = None,
        is_video: bool = False,
    ) -> Batch:
        """The SHARED part of every prompt over `image`: the chat template up
        to and including `<|vision_end|>` (system preamble + expanded image
        pads), as a leading-dim-1 model batch. Splitting here is tokenization-
        safe: `<|vision_end|>` is a special token, so BPE never merges across
        the boundary and encode(prefix) + encode(suffix) == encode(full) —
        asserted in tests/test_serve.py. Pair with `build_suffix_ids` and
        `serve.SharedPrefix` for prefix-KV-cached serving."""
        head, _tail = CHAT_TEMPLATE.split("{content}")
        vis = VIDEO_CONTENT if is_video else IMAGE_CONTENT
        return self.build_batch(
            [head + vis],
            [image],
            prompt_bucket=prefix_bucket,
            patch_bucket=patch_bucket,
            apply_template=False,
        )

    def build_suffix_ids(self, prompt: str) -> List[int]:
        """The PER-REQUEST remainder of a templated prompt: the user's text
        plus the template tail (`<|im_end|>\\n<|im_start|>assistant\\n`).
        Concatenating a `build_prefix_batch` prompt with these ids reproduces
        `build_batch([prompt], [image])`'s token stream exactly."""
        _head, tail = CHAT_TEMPLATE.split("{content}")
        return self.encode(prompt + tail)

    # ------------------------------------------------------------------
    # batch building
    # ------------------------------------------------------------------
    def build_batch(
        self,
        prompts: List[str],
        images: Optional[List[Any]] = None,
        completions: Optional[List[str]] = None,
        prompt_bucket: Optional[int] = None,
        completion_bucket: Optional[int] = None,
        patch_bucket: Optional[int] = None,
        apply_template: bool = True,
    ) -> Batch:
        """Prompts (+ optional right-padded completions for training) -> static
    padded model batch. Prompt side is LEFT padded (decoder-only generation,
    reference `utils.py:221-228`); completions RIGHT padded
    (`padt_sft_trainer.py:432-438`)."""
        cfg = self.cfg
        b = len(prompts)
        assert images is None or len(images) == b

        processed: List[Optional[ProcessedImage]] = []
        if images is not None:
            for img in images:
                if img is None or isinstance(img, ProcessedImage):
                    processed.append(img)
                else:
                    processed.append(
                        process_image(
                            img, self.min_pixels, self.max_pixels,
                            u8_rows=self.u8_pixels,
                        )
                    )
        else:
            processed = [None] * b

        grid_list = [(p.grid_thw if p else (0, 0, 0)) for p in processed]
        if any(p is not None for p in processed):
            max_m = max(p.num_merged_patches for p in processed if p is not None)
            self.ensure_vrt_tokens(max_m)

        # tokenize prompts, expanding <|image_pad|>/<|video_pad|> to the merged
        # patch count (video reuses the image machinery; grid t > 1)
        pad_ids = (cfg.image_token_id, cfg.video_token_id)
        prompt_ids: List[List[int]] = []
        for i, text in enumerate(prompts):
            if apply_template:
                text = self.apply_chat_template(
                    text,
                    has_image=processed[i] is not None,
                    is_video=processed[i] is not None and processed[i].is_video,
                )
            ids = self.encode(text)
            if processed[i] is not None:
                n = processed[i].num_merged_patches
                out: List[int] = []
                for t in ids:
                    if t in pad_ids:
                        out.extend([t] * n)
                    else:
                        out.append(t)
                ids = out
            prompt_ids.append(ids)

        lp = max(len(x) for x in prompt_ids)
        lp = prompt_bucket or round_up(lp, self.seq_bucket)
        comp_ids: List[List[int]] = []
        lc = 0
        if completions is not None:
            comp_ids = [self.encode(c) for c in completions]
            lc = max(len(x) for x in comp_ids)
            lc = completion_bucket or round_up(lc, self.seq_bucket)

        l = lp + lc
        input_ids = np.full((b, l), cfg.pad_token_id, np.int32)
        attention_mask = np.zeros((b, l), np.int32)
        completion_mask = np.zeros((b, l), np.int32)
        for i in range(b):
            p = prompt_ids[i]
            if len(p) > lp:
                raise ValueError(f"prompt length {len(p)} exceeds bucket {lp}")
            input_ids[i, lp - len(p) : lp] = p  # left pad
            attention_mask[i, lp - len(p) : lp] = 1
            if completions is not None:
                c = comp_ids[i]
                if len(c) > lc:
                    raise ValueError(f"completion length {len(c)} exceeds bucket {lc}")
                input_ids[i, lp : lp + len(c)] = c  # right pad
                attention_mask[i, lp : lp + len(c)] = 1
                completion_mask[i, lp : lp + len(c)] = 1

        grid_arr = np.asarray(grid_list, np.int64)
        spg = [(p.second_per_grid_t if p is not None else 0.0) for p in processed]
        pos, deltas = get_rope_index(
            input_ids, attention_mask, grid_arr, cfg.image_token_id,
            cfg.vision.spatial_merge_size,
            video_token_id=cfg.video_token_id,
            second_per_grid_ts=spg,
        )

        data: Dict[str, np.ndarray] = {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "position_ids": pos,
        }
        if completions is not None:
            data["completion_mask"] = completion_mask

        if any(p is not None for p in processed):
            s_max = patch_bucket or round_up(
                max(p.num_patches for p in processed if p is not None), self.patch_bucket
            )
            dim = cfg.vision.patch_input_dim
            # compact uint8 wire format (process_image(u8_rows=True)): when
            # every media sample carries it, the batch ships (S, C*P*P) uint8
            # rows — 4x fewer host->device bytes; normalize + temporal-dup run
            # inside the vision jit (models/padt.py::_expand_pixels_u8).
            # Mixed u8/f32 batches (e.g. image + video) fall back to f32 via
            # the host oracle so one batch keeps one pixel key.
            u8_all = all(
                p.pixel_patches_u8 is not None for p in processed if p is not None
            )
            if u8_all:
                dim8 = dim // cfg.vision.temporal_patch_size
                pix = np.zeros((b, s_max, dim8), np.uint8)
                for i, p in enumerate(processed):
                    if p is not None:
                        pix[i, : p.num_patches] = p.pixel_patches_u8
            else:
                from ..preprocess.vision_process import expand_u8_rows

                pix = np.zeros((b, s_max, dim), np.float32)
                for i, p in enumerate(processed):
                    if p is not None:
                        rows = (
                            p.pixel_patches
                            if p.pixel_patches is not None
                            else expand_u8_rows(
                                p.pixel_patches_u8, cfg.vision.temporal_patch_size
                            )
                        )
                        pix[i, : p.num_patches] = rows
            geom = vision_geometry(
                grid_list,
                s_max,
                cfg.vision.spatial_merge_size,
                cfg.vision.window_size,
                cfg.vision.patch_size,
            )
            data.update(
                **({"pixel_patches_u8": pix} if u8_all else {"pixel_patches": pix}),
                window_index=geom.window_index,
                inv_window_index=geom.inv_window_index,
                seg_win=geom.seg_win,
                seg_full=geom.seg_full,
                hpos=geom.hpos,
                wpos=geom.wpos,
                num_patches=geom.num_patches,
                num_merged=geom.num_merged,
                grid_thw=geom.grid_thw.astype(np.int32),
            )
            if geom.pack_index is not None:  # window-SLOT layout in use
                data.update(pack_index=geom.pack_index)
        return Batch(data=data, rope_deltas=deltas, prompt_length=lp)
