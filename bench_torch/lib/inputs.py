"""The benchmark's own construction of a query's model input, from the
query alone: what the reference reads, so that a fault in the program's
preprocessing cannot reach both sides of the check.

Written from the Qwen2.5-VL description (its chat template, its image
processor's `smart_resize` and patch layout) and the client-side resize
that PaDT's evaluation applies (`eval/test_demo.py`: the longer side to
644 px; `utils.py`: at least 28 px a side); it imports nothing of the
program. Tokens: the configuration's special-token ids, and one id per
word or run of punctuation, hashed (`encode`), which the benchmark also
hands the program as its tokenizer's text encoding (`lib/model.py`).
"""

from __future__ import annotations

import math
import re
import zlib
from typing import Dict, List, Tuple

import numpy as np

CHAT_TEMPLATE = (
    "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
    "<|im_start|>user\n<|vision_start|><|image_pad|><|vision_end|>{prompt}<|im_end|>\n"
    "<|im_start|>assistant\n"
)
IMAGE_PAD = "<|image_pad|>"
_SPECIAL_RE = re.compile(r"(<\|[^|<>]*\|>)")
_WORD_RE = re.compile(r" ?[A-Za-z0-9]+| ?[^A-Za-z0-9\s]+|\s+")
WORD_ID_LO = 256  # word ids lie above the mock tokenizer's 256 character ids


def word_id(piece: str, hi: int) -> int:
    return WORD_ID_LO + zlib.crc32(piece.encode()) % (hi - WORD_ID_LO)


def encode(text: str, special: Dict[str, int], hi: int) -> List[int]:
    """Special tokens by their ids; the rest one id per word or run of
    punctuation, hashed below `hi` (the lowest special id past the words)."""
    ids: List[int] = []
    for part in _SPECIAL_RE.split(text):
        if len(part) > 1 and part in special:
            ids.append(special[part])
        else:
            ids.extend(word_id(w, hi) for w in _WORD_RE.findall(part))
    return ids


def client_image(pixels: np.ndarray, max_side: int):
    """The image as the evaluation client hands it on: upscaled (Lanczos)
    until both sides are 28 px or more, then, where the longer side is
    over `max_side`, resized (Lanczos) so that it is `max_side`, each side
    truncated to whole pixels."""
    import PIL.Image

    img = PIL.Image.fromarray(pixels)
    w, h = img.size
    if w < 28 or h < 28:
        size = (28, int(h * (28 / w))) if w < h else (int(w * (28 / h)), 28)
        img = img.resize(size, PIL.Image.Resampling.LANCZOS)
    w, h = img.size
    if max(w, h) > max_side:
        s = max_side / max(w, h)
        img = img.resize((int(w * s), int(h * s)), PIL.Image.Resampling.LANCZOS)
    return img


def smart_resize(h: int, w: int, factor: int, min_pixels: int, max_pixels: int) -> Tuple[int, int]:
    """Qwen2-VL's image processor: each side rounded to a multiple of
    `factor`, then scaled into [min_pixels, max_pixels] at the same aspect."""
    hb, wb = max(factor, round(h / factor) * factor), max(factor, round(w / factor) * factor)
    if hb * wb > max_pixels:
        beta = math.sqrt(h * w / max_pixels)
        hb, wb = max(factor, math.floor(h / beta / factor) * factor), max(factor, math.floor(w / beta / factor) * factor)
    elif hb * wb < min_pixels:
        beta = math.sqrt(min_pixels / (h * w))
        hb, wb = math.ceil(h * beta / factor) * factor, math.ceil(w * beta / factor) * factor
    return hb, wb


def patch_rows(img, model: Dict) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """(S, C*P*P) uint8 patch rows of one frame in merge-block raster order
    (each 2x2 block of patches together, blocks row by row), and the grid
    (1, h, w) in patches. The image is resized (bicubic) to the
    `smart_resize` size; normalisation and the temporal copy are the
    model's (the reference's) own."""
    import PIL.Image

    vc, pre = model["vision_config"], model["preprocessor"]
    p, m = vc["patch_size"], vc["spatial_merge_size"]
    rh, rw = smart_resize(img.height, img.width, p * m, pre["min_pixels"], pre["max_pixels"])
    arr = np.asarray(img.convert("RGB").resize((rw, rh), PIL.Image.Resampling.BICUBIC), dtype=np.uint8)
    gh, gw = rh // p, rw // p
    rows = np.empty((gh * gw, 3 * p * p), np.uint8)
    k = 0
    for bh in range(gh // m):
        for bw in range(gw // m):
            for i in range(m):
                for j in range(m):
                    y, x = (bh * m + i) * p, (bw * m + j) * p
                    rows[k] = arr[y : y + p, x : x + p, :].transpose(2, 0, 1).reshape(-1)
                    k += 1
    return rows, (1, gh, gw)


def prompt_ids(prompt: str, grid: Tuple[int, int, int], model: Dict) -> np.ndarray:
    """The templated prompt's tokens, the image pad repeated once per merged
    patch."""
    special = model["special_tokens"]
    m = model["vision_config"]["spatial_merge_size"]
    n_merged = grid[0] * (grid[1] // m) * (grid[2] // m)
    ids: List[int] = []
    for t in encode(CHAT_TEMPLATE.format(prompt=prompt), special, word_id_hi(model)):
        ids.extend([t] * n_merged if t == special[IMAGE_PAD] else [t])
    return np.asarray(ids, np.int64)


def word_id_hi(model: Dict) -> int:
    return min(model[k] for k in ("vision_start_token_id", "image_token_id", "video_token_id", "pad_token_id",
                                  "eos_token_id"))
