"""Batched inference harness on PyTorch (port of `padt_tpu/eval/harness.py`,
`InferenceEngine.run_batch` + `_postprocess`): image + prompt ->
completion, boxes, scores, masks, with the same result types.

Differences from the JAX engine, all deliberate:
  - the pixel wire format (compact uint8 rows or f32 rows) is chosen per
    call: raw images are turned into `ProcessedImage`s here, so the shared
    processor is never mutated;
  - the batch carries whichever pixel key the processor produced
    (`pixel_patches` or `pixel_patches_u8`), and both are accepted;
  - the mask upsample is half-pixel bilinear (`F.interpolate(mode="bilinear",
    align_corners=False)`), the interpolation of `cv2.INTER_LINEAR`, so the
    port does not need OpenCV.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from padt_tpu.config import PaDTConfig
from padt_tpu.eval import rle as rle_codec
from padt_tpu.preprocess.vision_process import ProcessedImage, process_image
from padt_tpu.vrt.parser import pack_objects, parse_vrt_completions
from padt_tpu.vrt.processor import VisionTextProcessor

from ..models import padt as padt_model


@dataclass
class ObjectResult:
    label: str
    score: float
    bbox_xywh_px: Tuple[float, float, float, float]
    mask_rle: Optional[Dict]
    vrt_string: str


@dataclass
class SampleResult:
    completion: str
    objects: List[ObjectResult]


def _clean(s: str) -> str:
    return s.replace("<|endoftext|>", "").replace("<|im_end|>", "")


def upsample_logits(logit: np.ndarray, w_px: int, h_px: int) -> np.ndarray:
    """(h, w) f32 logits -> (h_px, w_px) by half-pixel bilinear
    interpolation (cv2.resize INTER_LINEAR's sampling)."""
    t = torch.as_tensor(np.ascontiguousarray(logit, np.float32))[None, None]
    up = F.interpolate(t, size=(int(h_px), int(w_px)), mode="bilinear", align_corners=False)
    return up[0, 0].numpy()


class InferenceEngine:
    def __init__(
        self,
        params,
        cfg: PaDTConfig,
        processor: VisionTextProcessor,
        max_new_tokens: int = 1024,
        canvas_hw: Optional[Tuple[int, int]] = None,
        compute_mask: bool = True,
        compact_pixels: bool = True,
    ):
        self.params = params
        self.cfg = cfg
        self.processor = processor
        self.compact_pixels = compact_pixels
        self.max_new_tokens = max_new_tokens
        side = int(cfg.max_image_patches**0.5) + 1
        self.canvas_hw = canvas_hw or (side, side)
        self.compute_mask = compute_mask
        self.device = params["text"]["embed"].device

    def _to_device(self, data: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in data.items():
            t = torch.as_tensor(np.asarray(v), device=self.device)
            out[k] = t.to(torch.bfloat16) if k == "pixel_patches" else t
        return out

    @torch.no_grad()
    def run_batch(
        self,
        prompts: List[str],
        images: List[Any],
        image_sizes: Optional[List[Tuple[int, int]]] = None,  # (W, H) px of the model input
        patch_bucket: Optional[int] = None,
        prompt_bucket: Optional[int] = None,
    ) -> List[SampleResult]:
        cfg, proc = self.cfg, self.processor
        if image_sizes is None:
            image_sizes = []
            for img in images:
                if isinstance(img, ProcessedImage):
                    _, h, w = img.grid_thw
                    image_sizes.append((w * cfg.vision.patch_size, h * cfg.vision.patch_size))
                else:
                    image_sizes.append(img.size)
        images = [
            img if img is None or isinstance(img, ProcessedImage)
            else process_image(img, proc.min_pixels, proc.max_pixels, u8_rows=self.compact_pixels)
            for img in images
        ]
        batch = proc.build_batch(
            prompts, images, patch_bucket=patch_bucket or cfg.max_image_patches,
            prompt_bucket=prompt_bucket,
        )
        tbatch = self._to_device(batch.data)
        deltas = torch.as_tensor(batch.rope_deltas, device=self.device)
        out = padt_model.generate(self.params, cfg, tbatch, self.max_new_tokens, deltas)
        return self._postprocess(out.tokens.cpu().numpy(), out.hidden, out.artifacts, image_sizes)

    @torch.no_grad()
    def _postprocess(self, tokens, hidden, art, image_sizes) -> List[SampleResult]:
        cfg, proc = self.cfg, self.processor
        b = tokens.shape[0]
        token_strs = [proc.token_strings(tokens[i]) for i in range(b)]
        parsed = parse_vrt_completions(token_strs, tokens, cfg.text.vocab_size)
        objects = parsed.all_objects
        results = [SampleResult(completion=_clean(parsed.completions[i]), objects=[]) for i in range(b)]
        if not objects:
            return results

        n_max = -(-max(cfg.max_objects, len(objects)) // cfg.max_objects) * cfg.max_objects
        obj_sample, gather_pos, counts, valid = pack_objects(objects, n_max, cfg.max_vrt_per_object)
        dev = hidden.device
        obj_sample_t = torch.as_tensor(obj_sample, device=dev).long()
        feats = hidden[obj_sample_t[:, None], torch.as_tensor(gather_pos, device=dev).long()]
        dec = padt_model.vl_decode(
            self.params, cfg, feats, torch.as_tensor(counts, device=dev),
            torch.as_tensor(valid, device=dev), obj_sample_t, art,
            canvas_hw=self.canvas_hw, compute_mask=self.compute_mask,
        )
        boxes = dec.pred_boxes.double().cpu().numpy()
        scores = 1.0 / (1.0 + np.exp(-dec.pred_score.double().cpu().numpy()[:, 0]))
        masks = dec.pred_mask.cpu().numpy() if self.compute_mask else None
        mask_hw = dec.mask_hw.cpu().numpy()

        for oi, obj in enumerate(objects):
            w_px, h_px = image_sizes[obj.sample]
            cx, cy, bw, bh = boxes[oi]
            ex = (max(cx - bw / 2, 0.0), max(cy - bh / 2, 0.0), min(bw, 1.0), min(bh, 1.0))
            bbox = (round(ex[0] * w_px), round(ex[1] * h_px), round(ex[2] * w_px), round(ex[3] * h_px))
            mask_rle = None
            if masks is not None:
                gh, gw = int(mask_hw[oi, 0]), int(mask_hw[oi, 1])
                up = upsample_logits(masks[oi, : gh * 4, : gw * 4], w_px, h_px)
                mask_rle = rle_codec.encode((up > 0).astype(np.uint8))  # sigmoid(x) > .5 iff x > 0
            results[obj.sample].objects.append(
                ObjectResult(
                    label=obj.label, score=float(scores[oi]), bbox_xywh_px=bbox,
                    mask_rle=mask_rle, vrt_string=obj.vrt_string,
                )
            )
        return results
