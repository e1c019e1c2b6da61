"""Single-image demo: REC/OVD/RIC prompt -> completion, boxes, masks, VRT
overlay (the port's counterpart of `scripts/demo.py`).

Rebuilds `eval/test_demo.py` (reference): loads a PaDT checkpoint, resizes the
image to max side 644 (the reference's inference tip, test_demo.py:64-73),
generates greedily, parses VRTs, decodes boxes/masks, and draws
pred_box.png / mask_seg.png / vrt_seg.png into --output_dir (OpenCV draws
them; everything before the drawing needs no OpenCV).

Usage:
  python -m padt_tpu_torch.tools.demo --model /path/to/PaDT_Pro_3B --image img.jpg \\
      --prompt 'Please carefully check the image and detect the object this sentence describes: "The car is on the left side of the horse".'

Golden regression gate (--check-golden): with the released PaDT_Pro_3B
weights staged locally and the reference demo image (COCO
000000368335.jpg), asserts the generated VRT sequence matches the
reference's golden output (`eval/outputs/demo/completion.txt:7`: VRT
122,107,138,256,135) plus box/score/mask sanity. Exits 0 on PASS, 1 on
FAIL: a one-command real-weights parity check. `--device cpu` runs it
without a card.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np

# reference golden output for the demo image + REC prompt
# (reference eval/outputs/demo/completion.txt:7)
GOLDEN_VRTS = "122,107,138,256,135"


def check_golden(completion, objects, image_wh, golden_vrts=GOLDEN_VRTS):
    """Returns a list of failure strings (empty == PASS).

    Checks: the exact golden VRT token run appears in the completion; at
    least one object parsed; its box is a sane in-image rectangle with a
    finite score; the mask (when present) is non-empty."""
    from ..eval import rle as rle_codec

    fails = []
    seq = "".join(f"<|VRT_{i.strip()}|>" for i in golden_vrts.split(",") if i.strip())
    if seq and seq not in completion:
        fails.append(f"golden VRT sequence {seq} not in completion: {completion!r}")
    if not objects:
        fails.append("no objects parsed from completion")
        return fails
    w_img, h_img = image_wh
    for obj in objects:
        x, y, w, h = obj.bbox_xywh_px
        if not (np.isfinite([x, y, w, h]).all() and w > 0 and h > 0):
            fails.append(f"degenerate box {obj.bbox_xywh_px}")
        elif not (-1 <= x <= w_img and -1 <= y <= h_img and x + w <= w_img + 1 and y + h <= h_img + 1):
            fails.append(f"box {obj.bbox_xywh_px} outside image {image_wh}")
        if not np.isfinite(obj.score):
            fails.append(f"non-finite score {obj.score}")
        if obj.mask_rle is not None and rle_codec.decode(obj.mask_rle).sum() == 0:
            fails.append("empty mask")
    return fails


def draw(img, objects, output_dir):
    """pred_box.png / mask_seg.png / vrt_seg.png (test_demo.py:116-176)."""
    import cv2

    from ..eval import rle as rle_codec
    from ..utils.resize import resize_linear_u8

    im = cv2.cvtColor(np.asarray(img), cv2.COLOR_RGB2BGR)
    im_h, im_w = im.shape[:2]
    patch_w = round(im_w / 28)
    resized_w, resized_h = patch_w * 28, round(im_h / 28) * 28
    im = cv2.resize(im, (resized_w, resized_h))
    mask_seg = np.zeros_like(im)
    vrt_seg = np.zeros_like(im)
    colors = np.array([[0, 0, 255], [0, 165, 255], [0, 215, 255], [0, 255, 127], [255, 0, 0]])
    for idx, obj in enumerate(objects):
        x, y, w, h = obj.bbox_xywh_px
        sx, sy = resized_w / im_w, resized_h / im_h
        x, y, w, h = round(x * sx), round(y * sy), round(w * sx), round(h * sy)
        cv2.rectangle(im, (x, y), (x + w, y + h), (0, 0, 255), 2)
        cv2.putText(im, f"{obj.label} {obj.score:.2f}", (x, max(y - 4, 12)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, (0, 0, 255), 1, cv2.LINE_AA)
        if obj.mask_rle is not None:
            m = rle_codec.decode(obj.mask_rle).astype(np.uint8)
            mask_seg[resize_linear_u8(m, (resized_w, resized_h)) > 0] = colors[idx % 5]
        for vi, vrt_idx in enumerate(re.findall(r"<\|VRT_(\d+)\|>", obj.vrt_string)):
            vx, vy = int(vrt_idx) % patch_w, int(vrt_idx) // patch_w
            vrt_seg[vy * 28 : (vy + 1) * 28, vx * 28 : (vx + 1) * 28] = colors[vi % 5]
            cv2.putText(vrt_seg, vrt_idx, (vx * 28, vy * 28 + 14),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, (0, 0, 0), 1, cv2.LINE_AA)
    cv2.imwrite(os.path.join(output_dir, "pred_box.png"), im)
    cv2.imwrite(os.path.join(output_dir, "mask_seg.png"), mask_seg)
    cv2.imwrite(os.path.join(output_dir, "vrt_seg.png"), (vrt_seg * 0.6 + im * 0.4).astype(np.uint8))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--image", required=True)
    ap.add_argument(
        "--prompt",
        default='Please carefully check the image and detect the object this sentence describes: "The car is on the left side of the horse".',
    )
    ap.add_argument("--output_dir", default="outputs/demo")
    ap.add_argument("--max_new_tokens", type=int, default=1024)
    ap.add_argument("--max_side", type=int, default=644)
    ap.add_argument("--check-golden", dest="check_golden", action="store_true",
                    help="assert the golden VRT sequence + box/mask sanity; exit 1 on mismatch")
    ap.add_argument("--golden_vrts", default=GOLDEN_VRTS,
                    help="comma-separated expected VRT patch ids (empty = sanity checks only)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import PIL.Image

    from ..api import load_model
    from ..eval.harness import InferenceEngine
    from ..preprocess.vision_process import ensure_min_28, resize_max_side

    cfg, params, processor = load_model(args.model, device=args.device)
    engine = InferenceEngine(params, cfg, processor, max_new_tokens=args.max_new_tokens)

    img = ensure_min_28(PIL.Image.open(args.image).convert("RGB"))
    if max(img.size) > args.max_side:
        img = resize_max_side(img, args.max_side)
    res = engine.run_batch([args.prompt], [img])[0]

    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "completion.txt"), "w") as f:
        f.write("Prompt: " + args.prompt + "\n")
        f.write("Completion: " + res.completion + "\n")
    print("Completion:", res.completion)

    if args.check_golden:
        fails = check_golden(res.completion, res.objects, img.size, args.golden_vrts)
        if fails:
            for msg in fails:
                print("GOLDEN FAIL:", msg)
            return 1
        print("GOLDEN PASS:", len(res.objects), "object(s), VRTs match")

    draw(img, res.objects, args.output_dir)
    print("Wrote", args.output_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
