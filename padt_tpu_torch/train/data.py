"""Training data pipeline: JSONL rows -> static padded device batches.

The port's copy of `padt_tpu/train/data.py`: the same code with its imports
inside this package, `resize_linear` (numpy, equal to OpenCV's `cv2.resize`
with INTER_LINEAR on float32 masks) in place of `cv2.resize`, which the
machine with the card does not have, and batches of compact uint8 pixel
rows accepted as well as float rows.

Rebuilds the host-side half of the reference training step
(`padt_sft_trainer.py:330-466` + `sft_train.py:26-81`):
  - JSONL loading/normalization (`{image, conversations, answer_template,
    objects}` -> `{image_path, problem, solution}`),
  - completion synthesis: `<|Obj_k|>` placeholders replaced by picked
    `<|VRT_*|>` runs (three picking modes: all patches / 5 extremes+center /
    random-k, `padt_sft_trainer.py:377-402`),
  - robust-CE VP penalty masks (`:443-457`),
  - GT box/mask target assembly (RLE decode + resize to the 4x-per-patch mask
    canvas, `:490-503`).

TPU-first divergence: the reference re-decodes the completion token stream
INSIDE the loss to find VRT positions (`padt_sft_trainer.py:478-479`, a
host<->device ping-pong per step); here VRT positions/ids are computed at batch
build time and passed as index arrays into the jitted step (SURVEY.md §7
"hard parts").
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..config import PaDTConfig
from ..eval import rle as rle_codec
from ..vrt.processor import VisionTextProcessor


# ---------------------------------------------------------------------------
# dataset loading (sft_train.py:26-81 semantics)
# ---------------------------------------------------------------------------

def load_jsonl_datasets(data_files: Sequence[str], image_folders: Sequence[str]) -> List[Dict]:
    assert len(data_files) == len(image_folders), "data files must match image folders"
    samples = []
    for data_file, folder in zip(data_files, image_folders):
        if os.path.exists(data_file):
            with open(data_file) as f:
                rows = [json.loads(line) for line in f if line.strip()]
        else:
            # HF-hub fallback (reference sft_train.py:33-44): treat the path
            # as <repo_id>/<file> and pull via datasets. Requires network;
            # gated behind the import so offline local-JSONL use never pays it.
            from datasets import load_dataset

            repo, fname = os.path.dirname(data_file), os.path.basename(data_file)
            rows = load_dataset(repo, data_files=fname)["train"].to_list()
        for item in rows:
            image = item.get("image")
            if isinstance(image, str):
                paths = [os.path.join(folder, image)]
            elif isinstance(image, list):
                paths = [os.path.join(folder, p) for p in image]
            else:
                paths = []
            problem = item["conversations"][0]["value"].replace("<image>", "")
            samples.append(
                {
                    "id": item.get("id"),
                    "image_path": paths,
                    "problem": problem,
                    "solution": {"text": item["answer_template"], "objects": item["objects"]},
                }
            )
    return samples


# ---------------------------------------------------------------------------
# patch picking (padt_sft_trainer.py:377-402)
# ---------------------------------------------------------------------------

def pick_patches(
    patches: np.ndarray,
    patch_w: int,
    rng: np.random.RandomState,
    random_select_patch: bool = False,
    random_select_patch_num: int = 5,
) -> np.ndarray:
    """Choose which GT patches become the object's VRT run."""
    patches = np.asarray(patches)
    if random_select_patch_num < 0:
        return patches.copy()
    if not random_select_patch:
        xs, ys = patches % patch_w, patches // patch_w
        left = patches[xs == xs.min()]
        right = patches[xs == xs.max()]
        top = patches[ys == ys.min()]
        bottom = patches[ys == ys.max()]
        centre_m = (
            (xs == xs.min()) | (xs == xs.max()) | (ys == ys.min()) | (ys == ys.max())
        ) == False  # noqa: E712 — mirrors the reference's sum==0 test
        centre = patches[centre_m]
        if centre.size == 0:
            centre = patches
        return np.array(
            [rng.choice(centre), rng.choice(left), rng.choice(top), rng.choice(right), rng.choice(bottom)]
        )
    k = random_select_patch_num
    replace = patches.shape[0] < k
    return rng.choice(patches, k, replace=replace)


# ---------------------------------------------------------------------------
# completion synthesis
# ---------------------------------------------------------------------------

import re

_OBJ_RE = re.compile(r"<\|Obj_(\d+)\|>")


@dataclass
class SynthesizedSample:
    completion: str  # with VRT runs + eos
    objects: List[Dict]  # each: {patches, picked, bbox, rle?, label?}


def synthesize_completion(
    solution: Dict,
    patch_w: int,
    processor: VisionTextProcessor,
    rng: np.random.RandomState,
    eos_token: str = "<|im_end|>",
    random_select_patch: bool = False,
    random_select_patch_num: int = 5,
) -> SynthesizedSample:
    """Replace `<|Obj_k|>` with picked `<|VRT_*|>` strings
    (padt_sft_trainer.py:359-412)."""
    text = solution["text"]
    matches = list(_OBJ_RE.finditer(text))
    parts = _OBJ_RE.split(text)
    # parts = [text0, idx0, text1, idx1, ...]
    out = parts[0]
    new_objects = []
    for j, m in enumerate(matches):
        obj = dict(solution["objects"][int(m.group(1))])
        picked = pick_patches(
            np.asarray(obj["patches"]), patch_w, rng, random_select_patch, random_select_patch_num
        )
        obj["picked"] = picked
        new_objects.append(obj)
        out += processor.pid2vrt(picked) + parts[2 * j + 2]
    return SynthesizedSample(completion=out + eos_token, objects=new_objects)


# ---------------------------------------------------------------------------
# mask resize (OpenCV's INTER_LINEAR on float32, in numpy)
# ---------------------------------------------------------------------------

def _linear_taps(n_src: int, n_dst: int):
    """Source index pairs and fp32 weights of each destination pixel along
    one axis, as OpenCV computes them: f = (d + 0.5) * n_src / n_dst - 0.5
    in float64, its floor and fraction, clamped to the edge pixels; the
    weights 1 - frac and frac rounded to float32."""
    f = (np.arange(n_dst, dtype=np.float64) + 0.5) * (n_src / n_dst) - 0.5
    s = np.floor(f).astype(np.int64)
    f = f - s
    edge = (s < 0) | (s >= n_src - 1)
    f[edge] = 0.0
    s = np.clip(s, 0, n_src - 1)
    return s, np.minimum(s + 1, n_src - 1), (1.0 - f).astype(np.float32), f.astype(np.float32)


def resize_linear(src: np.ndarray, dsize) -> np.ndarray:
    """`cv2.resize(src, dsize)` (INTER_LINEAR) of a 2-D float32 array;
    dsize = (width, height). An exact 2x downscale on both axes averages
    each 2x2 block, as OpenCV switches to its area path there."""
    src = np.asarray(src, np.float32)
    (h, w), (dw, dh) = src.shape, dsize
    if w == 2 * dw and h == 2 * dh:
        return ((src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2] + src[1::2, 1::2]) * np.float32(0.25)).astype(np.float32)
    x0, x1, ax0, ax1 = _linear_taps(w, dw)
    y0, y1, ay0, ay1 = _linear_taps(h, dh)
    rows = src[:, x0] * ax0 + src[:, x1] * ax1  # (h, dw): the horizontal pass
    return (rows[y0] * ay0[:, None] + rows[y1] * ay1[:, None]).astype(np.float32)


# ---------------------------------------------------------------------------
# batch building
# ---------------------------------------------------------------------------

@dataclass
class TrainBatch:
    model: Dict[str, np.ndarray]  # jitted-step inputs (incl. targets)
    prompt_length: int
    rope_deltas: np.ndarray
    meta: Dict[str, Any] = field(default_factory=dict)


def build_train_batch(
    samples: List[Dict],
    processor: VisionTextProcessor,
    cfg: PaDTConfig,
    rng: np.random.RandomState,
    images: Optional[List[Any]] = None,  # preloaded PIL/ProcessedImage (else load from path)
    random_select_patch: bool = False,
    random_select_patch_num: int = 5,
    prompt_bucket: Optional[int] = None,
    completion_bucket: Optional[int] = None,
    patch_bucket: Optional[int] = None,
    canvas_hw: Optional[tuple] = None,
    use_mask_targets: bool = True,
    batch_idx: Optional[List[int]] = None,  # dataset indices (vision-feature cache keys)
) -> TrainBatch:
    from ..preprocess.vision_process import ProcessedImage, ensure_min_28, process_image

    b = len(samples)
    if images is None:
        import PIL.Image

        images = []
        for s in samples:
            assert len(s["image_path"]) == 1, "one image per sample (padt_sft_trainer.py:341)"
            images.append(ensure_min_28(PIL.Image.open(s["image_path"][0])))

    processed = [
        img if isinstance(img, ProcessedImage) else process_image(img, processor.min_pixels, processor.max_pixels)
        for img in images
    ]

    # synthesize completions with picked patches
    synths: List[SynthesizedSample] = []
    prompts: List[str] = []
    for s, p in zip(samples, processed):
        patch_w = p.grid_thw[2] // cfg.vision.spatial_merge_size
        synths.append(
            synthesize_completion(
                s["solution"], patch_w, processor, rng,
                random_select_patch=random_select_patch,
                random_select_patch_num=random_select_patch_num,
            )
        )
        prompts.append(s["problem"])

    batch = processor.build_batch(
        prompts,
        processed,
        completions=[s.completion for s in synths],
        prompt_bucket=prompt_bucket,
        completion_bucket=completion_bucket,
        patch_bucket=patch_bucket,
    )
    d = dict(batch.data)
    lp = batch.prompt_length
    l = d["input_ids"].shape[1]
    lc = l - lp
    v = cfg.text.vocab_size
    m_max = d["num_merged"].max() if "num_merged" in d else cfg.max_merged_patches
    # either pixel wire format (the original reads only "pixel_patches" and
    # raises a KeyError on compact uint8 rows)
    pix = d["pixel_patches"] if "pixel_patches" in d else d["pixel_patches_u8"]
    m_bucket = pix.shape[1] // cfg.vision.spatial_merge_unit

    # --- VP penalty mask + object index arrays ---
    n_max = cfg.max_objects
    k_max = cfg.max_vrt_per_object
    penalty = np.zeros((b, lc, m_bucket), bool)
    obj_sample = np.zeros((n_max,), np.int32)
    gather_pos = np.zeros((n_max, k_max), np.int32)  # absolute seq positions (predicting hidden)
    vrt_counts = np.zeros((n_max,), np.int32)
    obj_valid = np.zeros((n_max,), bool)
    picked_ids = np.zeros((n_max, k_max), np.int32)
    gt_boxes = np.zeros((n_max, 4), np.float32)
    hc, wc = canvas_hw or (int(m_bucket**0.5) * 2 + 2,) * 2
    gt_mask = np.zeros((n_max, hc * 4, wc * 4), np.float32)
    gt_mask_valid = np.zeros((n_max, hc * 4, wc * 4), np.float32)

    comp_ids = d["input_ids"][:, lp:]
    oi = 0
    for i, (s, synth, proc) in enumerate(zip(samples, synths, processed)):
        # positions of this sample's VRT tokens within the completion, in order
        vrt_positions = np.nonzero(comp_ids[i] >= v)[0]
        consumed = 0
        for obj in synth.objects:
            picked = np.asarray(obj["picked"], np.int64)
            npick = picked.shape[0]
            pos = vrt_positions[consumed : consumed + npick]
            consumed += npick
            if oi >= n_max:
                continue
            # robust-CE: at each picked-VRT position, the object's other GT
            # patches are excluded from the softmax; its own pick stays
            gt_patches = np.asarray(obj["patches"], np.int64)
            for row, pk in zip(pos, picked):
                penalty[i, row, gt_patches] = True
                penalty[i, row, pk] = False
            obj_sample[oi] = i
            cnt = min(npick, k_max)
            # hidden that PREDICTS completion position p is at absolute p + lp - 1
            gather_pos[oi, :cnt] = pos[:cnt] + lp - 1
            picked_ids[oi, :cnt] = picked[:cnt]
            vrt_counts[oi] = cnt
            obj_valid[oi] = cnt > 0
            gt_boxes[oi] = np.asarray(obj["bbox"], np.float32)  # xyxy in [0,1]
            if use_mask_targets and "rle" in obj and obj["rle"]:
                gm = rle_codec.decode(obj["rle"]).astype(np.float32)
                gh, gw = int(proc.grid_thw[1]), int(proc.grid_thw[2])
                resized = resize_linear(gm, (gw * 4, gh * 4)) > 0.5
                gt_mask[oi, : gh * 4, : gw * 4] = resized
                gt_mask_valid[oi, : gh * 4, : gw * 4] = 1.0
            oi += 1

    d.update(
        vrt_penalty_mask=penalty,
        obj_sample=obj_sample,
        gather_pos=gather_pos,
        vrt_counts=vrt_counts,
        obj_valid=obj_valid,
        picked_patch_ids=picked_ids,
        gt_boxes=gt_boxes,
        gt_mask=gt_mask,
        gt_mask_valid=gt_mask_valid,
    )
    meta: Dict[str, Any] = {"canvas_hw": (hc, wc)}
    if batch_idx is not None:
        meta["batch_idx"] = list(batch_idx)
    return TrainBatch(model=d, prompt_length=lp, rope_deltas=batch.rope_deltas, meta=meta)
