"""Qwen2.5-VL image preprocessing in pure numpy/PIL (the port's copy of
`padt_tpu/preprocess/vision_process.py`).

Replaces the reference's dependency on HF `Qwen2VLImageProcessor` +
`qwen_vl_utils.process_vision_info` (reference `eval/test_demo.py:2,62`).
Behavior parity targets:
  - smart_resize rounding to multiples of patch*merge=28 within [min_pixels, max_pixels],
  - bicubic resize, rescale 1/255, OPENAI-CLIP mean/std normalization,
  - patch flattening into (grid_t*grid_h*grid_w, C*tP*P*P) rows ordered by
    2x2 spatial-merge groups (so consecutive 4 rows form one merged patch),
  - min-28px guard used by the reference at call sites
    (`eval/evaluation_scripts/utils.py:205-219`, `padt_sft_trainer.py:344-356`),
  - max-side-644 eval-time resize tip (`eval/test_demo.py:64-73`).
Verified against transformers' Qwen2VLImageProcessor in tests/test_preprocess.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

IMAGE_FACTOR = 28
DEFAULT_MIN_PIXELS = 56 * 56
DEFAULT_MAX_PIXELS = 28 * 28 * 1280
MAX_RATIO = 200


def round_by_factor(x: float, factor: int) -> int:
    return round(x / factor) * factor


def ceil_by_factor(x: float, factor: int) -> int:
    return math.ceil(x / factor) * factor


def floor_by_factor(x: float, factor: int) -> int:
    return math.floor(x / factor) * factor


def smart_resize(
    height: int,
    width: int,
    factor: int = IMAGE_FACTOR,
    min_pixels: int = DEFAULT_MIN_PIXELS,
    max_pixels: int = DEFAULT_MAX_PIXELS,
) -> Tuple[int, int]:
    """Rescale (height, width) to multiples of `factor` within the pixel budget.

    Same rounding rules as the HF Qwen2-VL processor; any off-by-one here would
    shift the whole VRT patch grid (see SURVEY.md "hard parts").
    """
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(
            f"absolute aspect ratio must be smaller than {MAX_RATIO}, got "
            f"{max(height, width) / min(height, width)}"
        )
    h_bar = max(factor, round_by_factor(height, factor))
    w_bar = max(factor, round_by_factor(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, floor_by_factor(height / beta, factor))
        w_bar = max(factor, floor_by_factor(width / beta, factor))
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by_factor(height * beta, factor)
        w_bar = ceil_by_factor(width * beta, factor)
    return h_bar, w_bar


def ensure_min_28(image):
    """Upscale so both sides are >=28px, keeping aspect ratio (reference
    `utils.py:205-219`)."""
    import PIL.Image

    w, h = image.size
    if w >= 28 and h >= 28:
        return image
    if w < h:
        new_w, new_h = 28, int(h * (28 / w))
    else:
        new_h, new_w = 28, int(w * (28 / h))
    return image.resize((new_w, new_h), PIL.Image.Resampling.LANCZOS)


def resize_max_side(image, max_side: int = 644):
    """Eval-time resize tip: COCO train images are <=640px so cap the max side
    at 644 (reference `eval/test_demo.py:64-73`)."""
    import PIL.Image

    w, h = image.size
    scale = max_side / max(w, h)
    return image.resize((int(w * scale), int(h * scale)), PIL.Image.Resampling.LANCZOS)


@dataclass
class ProcessedImage:
    pixel_patches: Optional[np.ndarray]  # (grid_t*grid_h*grid_w, C*tP*P*P) float32
    grid_thw: Tuple[int, int, int]  # (t, h, w) in 14px patch units
    # compact wire format (images only, u8_rows=True): the SAME patch rows but
    # pre-normalization uint8 and without the temporal duplication —
    # (S, C*P*P) = 4x fewer bytes host->device than f32-normalized rows cast
    # to bf16. Normalize + temporal-dup run on device (padt._expand_pixels_u8)
    # with bitwise-identical f32 math; see expand_u8_rows for the host oracle.
    pixel_patches_u8: Optional[np.ndarray] = None
    # video-only metadata (images keep the defaults): seconds covered by one
    # temporal grid step, and the flag that routes <|video_pad|> templating
    second_per_grid_t: float = 0.0
    is_video: bool = False

    @property
    def num_patches(self) -> int:
        t, h, w = self.grid_thw
        return t * h * w

    @property
    def num_merged_patches(self) -> int:
        t, h, w = self.grid_thw
        return t * h * w // 4


def process_image(
    image,
    min_pixels: int = DEFAULT_MIN_PIXELS,
    max_pixels: int = DEFAULT_MAX_PIXELS,
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
    mean: Tuple[float, ...] = OPENAI_CLIP_MEAN,
    std: Tuple[float, ...] = OPENAI_CLIP_STD,
    u8_rows: bool = False,
) -> ProcessedImage:
    """PIL image (or HWC uint8 array) -> flattened patch rows + grid_thw.

    Row ordering matches the HF processor: reshape to
      (grid_t, tP, C, grid_h/m, m, P, grid_w/m, m, P)
    then transpose to (grid_t, grid_h/m, grid_w/m, m, m, C, tP, P, P) and flatten —
    i.e. rows are grouped by 2x2 merge blocks in raster order of merged patches.

    u8_rows=True: return `pixel_patches_u8` (S, C*P*P) uint8 instead — the
    identical spatial row layout, but straight from the resized uint8 pixels
    (no normalization, no temporal duplication; for a single image both
    temporal copies are the same frame). The device expands it back with
    bitwise-identical f32 math (models/padt.py::_expand_pixels_u8); over the
    host<->device link it is 4x smaller than bf16-cast normalized rows.
    """
    import PIL.Image

    if isinstance(image, np.ndarray):
        image = PIL.Image.fromarray(image)
    if image.mode != "RGB":
        image = image.convert("RGB")

    h, w = image.height, image.width
    resized_h, resized_w = smart_resize(h, w, IMAGE_FACTOR, min_pixels, max_pixels)
    image = image.resize((resized_w, resized_h), PIL.Image.Resampling.BICUBIC)

    if u8_rows:
        arr = np.asarray(image, dtype=np.uint8).transpose(2, 0, 1)  # CHW
        channel = arr.shape[0]
        grid_h, grid_w = resized_h // patch_size, resized_w // patch_size
        # same 9-dim reshape/transpose as below with (grid_t, tP) = (1, 1):
        # spatial ordering (merge-block raster) is identical by construction
        patches = arr.reshape(
            1, 1, channel,
            grid_h // merge_size, merge_size, patch_size,
            grid_w // merge_size, merge_size, patch_size,
        )
        patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
        flat = patches.reshape(grid_h * grid_w, channel * patch_size * patch_size)
        return ProcessedImage(
            pixel_patches=None,
            grid_thw=(1, grid_h, grid_w),
            pixel_patches_u8=np.ascontiguousarray(flat),
        )

    arr = np.asarray(image, dtype=np.float32) / 255.0  # HWC
    arr = (arr - np.asarray(mean, dtype=np.float32)) / np.asarray(std, dtype=np.float32)
    arr = arr.transpose(2, 0, 1)  # CHW

    patches = arr[np.newaxis]  # (1, C, H, W) — single frame
    if patches.shape[0] % temporal_patch_size != 0:
        reps = np.tile(patches[-1:], (temporal_patch_size - patches.shape[0] % temporal_patch_size, 1, 1, 1))
        patches = np.concatenate([patches, reps], axis=0)

    channel = patches.shape[1]
    grid_t = patches.shape[0] // temporal_patch_size
    grid_h, grid_w = resized_h // patch_size, resized_w // patch_size
    patches = patches.reshape(
        grid_t,
        temporal_patch_size,
        channel,
        grid_h // merge_size,
        merge_size,
        patch_size,
        grid_w // merge_size,
        merge_size,
        patch_size,
    )
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = patches.reshape(
        grid_t * grid_h * grid_w, channel * temporal_patch_size * patch_size * patch_size
    )
    return ProcessedImage(pixel_patches=flat, grid_thw=(grid_t, grid_h, grid_w))


def expand_u8_rows(
    u8: np.ndarray,
    temporal_patch_size: int = 2,
    mean: Tuple[float, ...] = OPENAI_CLIP_MEAN,
    std: Tuple[float, ...] = OPENAI_CLIP_STD,
) -> np.ndarray:
    """Host oracle for the device-side u8 expansion: (S, C*P*P) uint8 ->
    (S, C*tP*P*P) float32 normalized rows, bitwise-equal to process_image()'s
    pixel_patches (the normalize/transpose order differs but every op is
    elementwise f32 — same IEEE results). Used for mixed u8/f32 batches and
    as the parity reference in tests."""
    s, d = u8.shape
    c = 3
    pp = d // c
    mean_a = np.asarray(mean, np.float32).reshape(1, c, 1)
    std_a = np.asarray(std, np.float32).reshape(1, c, 1)
    x = u8.astype(np.float32).reshape(s, c, pp) / np.float32(255.0)
    x = (x - mean_a) / std_a
    x = np.broadcast_to(x[:, :, None, :], (s, c, temporal_patch_size, pp))
    return np.ascontiguousarray(x.reshape(s, c * temporal_patch_size * pp))


def process_video(
    frames,  # list of PIL images / HWC uint8 arrays, or one (T, H, W, C) array
    fps: float = 2.0,
    min_pixels: int = DEFAULT_MIN_PIXELS,
    max_pixels: int = DEFAULT_MAX_PIXELS,
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
    mean: Tuple[float, ...] = OPENAI_CLIP_MEAN,
    std: Tuple[float, ...] = OPENAI_CLIP_STD,
) -> ProcessedImage:
    """Video frames -> flattened patch rows + grid_thw (t > 1).

    Mirrors the reference's qwen_vl_utils video path (inherited by PaDT from
    Qwen2.5-VL; the PaDT tasks are image-only but the base VLM supports video):
    every frame is smart-resized to one shared grid, consecutive
    `temporal_patch_size` frames are stacked into one patch row, the trailing
    frame is repeated to fill the last temporal group, and
    `second_per_grid_t = temporal_patch_size / fps` feeds the time-aligned
    M-RoPE t stream (get_rope_index)."""
    import PIL.Image

    if isinstance(frames, np.ndarray) and frames.ndim == 4:
        frames = [frames[i] for i in range(frames.shape[0])]
    pil_frames = []
    for f in frames:
        if isinstance(f, np.ndarray):
            f = PIL.Image.fromarray(f)
        if f.mode != "RGB":
            f = f.convert("RGB")
        pil_frames.append(f)

    h, w = pil_frames[0].height, pil_frames[0].width
    resized_h, resized_w = smart_resize(h, w, IMAGE_FACTOR, min_pixels, max_pixels)
    mean_a = np.asarray(mean, dtype=np.float32)
    std_a = np.asarray(std, dtype=np.float32)
    stack = []
    for f in pil_frames:
        f = f.resize((resized_w, resized_h), PIL.Image.Resampling.BICUBIC)
        arr = np.asarray(f, dtype=np.float32) / 255.0
        arr = (arr - mean_a) / std_a
        stack.append(arr.transpose(2, 0, 1))  # CHW
    patches = np.stack(stack, axis=0)  # (T, C, H, W)
    if patches.shape[0] % temporal_patch_size != 0:
        reps = np.tile(
            patches[-1:],
            (temporal_patch_size - patches.shape[0] % temporal_patch_size, 1, 1, 1),
        )
        patches = np.concatenate([patches, reps], axis=0)

    channel = patches.shape[1]
    grid_t = patches.shape[0] // temporal_patch_size
    grid_h, grid_w = resized_h // patch_size, resized_w // patch_size
    patches = patches.reshape(
        grid_t,
        temporal_patch_size,
        channel,
        grid_h // merge_size,
        merge_size,
        patch_size,
        grid_w // merge_size,
        merge_size,
        patch_size,
    )
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = patches.reshape(
        grid_t * grid_h * grid_w, channel * temporal_patch_size * patch_size * patch_size
    )
    return ProcessedImage(
        pixel_patches=flat,
        grid_thw=(grid_t, grid_h, grid_w),
        second_per_grid_t=temporal_patch_size / fps,
        is_video=True,
    )


def batch_images(
    processed: List[ProcessedImage], max_patches: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a list of per-sample images to a static (B, S_max, D) batch.

    TPU-first divergence from the reference: the reference packs all images into
    one varlen sequence with cu_seqlens (`padt.py:79-87`); we keep one image per
    sample (the trainer asserts single-image samples, `padt_sft_trainer.py:341`)
    and pad to a bucketed S_max so XLA sees static shapes.
    """
    if max_patches is None:
        max_patches = max(p.num_patches for p in processed)
        max_patches = -(-max_patches // 64) * 64  # round up to 64
    dim = processed[0].pixel_patches.shape[-1]
    out = np.zeros((len(processed), max_patches, dim), dtype=np.float32)
    grids = np.zeros((len(processed), 3), dtype=np.int32)
    for i, p in enumerate(processed):
        n = p.num_patches
        if n > max_patches:
            raise ValueError(f"image has {n} patches > bucket {max_patches}")
        out[i, :n] = p.pixel_patches
        grids[i] = p.grid_thw
    return out, grids
