"""Batched inference + scoring for OVD (COCO) and REC/RES (RefCOCO), the
port's counterpart of `scripts/infer_eval.py`.

Rebuilds `eval/evaluation_scripts/{inference_coco,inference_refcoco,eval_coco,
eval_refcoco}.py` as one CLI with two subcommands:

  infer: dataset JSONL -> prediction JSONL (reference schema)
    python -m padt_tpu_torch.tools.infer_eval infer --model CKPT --data val.jsonl \\
        --image_folder /data/coco/val2017 --dataset coco --batch_size 16

  score: prediction JSONL (+ GT) -> metrics
    python -m padt_tpu_torch.tools.infer_eval score --task coco \\
        --pred_glob 'outputs/coco/coco_*_pred_results_x.json' \\
        --processed_json val.jsonl --coco_json instances_val2017.json
    python -m padt_tpu_torch.tools.infer_eval score --task refcoco \\
        --pred_glob 'outputs/refcoco/...json' --processed_json refcoco_val.jsonl

`--model random:{tiny,3b,7b}` runs random weights at full model shapes (no
checkpoint on disk); `--device cpu` runs without a card. `score` prints the
metrics as JSON and returns them from `main`.
"""

from __future__ import annotations

import argparse
import glob
import json
import sys


def random_model(kind: str, device):
    """(cfg, params, processor) of random weights, seeded: bf16 on a card,
    float32 on the CPU."""
    import torch

    from ..config import padt_3b, padt_7b, padt_tiny
    from ..models.padt import init_padt_params
    from ..utils.mock_tokenizer import make_full_tokenizer, make_tiny_tokenizer
    from ..vrt.processor import VisionTextProcessor

    cfg = {"3b": padt_3b, "7b": padt_7b, "tiny": padt_tiny}[kind]()
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    params = init_padt_params(cfg, torch.Generator(device=device).manual_seed(0), device, dtype)
    tok = make_tiny_tokenizer(cfg) if kind == "tiny" else make_full_tokenizer(cfg)
    processor = VisionTextProcessor(tok, cfg)
    processor.prepare(cfg.text.vocab_size)
    return cfg, params, processor


def cmd_infer(a):
    from ..api import load_model
    from ..eval.harness import InferenceEngine, infer_dataset
    from ..train.data import load_jsonl_datasets

    if a.model.startswith("random:"):
        cfg, params, processor = random_model(a.model.split(":", 1)[1], a.device)
    else:
        cfg, params, processor = load_model(a.model, device=a.device)
    dataset = load_jsonl_datasets([a.data], [a.image_folder])
    engine = InferenceEngine(params, cfg, processor, max_new_tokens=a.max_new_tokens)
    # --passes 2: the second pass reuses the cached serve engine, so the
    # last pass's stats are the steady state
    for p in range(a.passes):
        if a.passes > 1:
            print(f"--- pass {p + 1}/{a.passes} ---")
        res, comp = infer_dataset(
            engine, dataset, a.output_dir, batch_size=a.batch_size,
            datasetname=a.dataset, suffix=a.suffix, max_side=a.max_side,
            stream=a.engine == "stream", share_prefix=a.share_prefix,
            n_slots=a.n_slots, prefill_bucket=a.prefill_bucket,
            chunk_steps=a.chunk_steps, prompt_bucket=a.prompt_bucket,
        )
    print("wrote", res, comp)
    return {"results": res, "completions": comp}


def _load_preds(pred_glob):
    preds = []
    for path in sorted(glob.glob(pred_glob)):
        with open(path) as f:
            preds.extend(json.loads(l) for l in f if l.strip())
    return preds


def cmd_score(a):
    preds = _load_preds(a.pred_glob)
    print(f"loaded {len(preds)} predictions")
    if a.task == "coco":
        # GT rebuilt from the processed JSONL against original COCO categories
        # (reference eval_coco.py:36-67)
        from ..eval.coco_map import COCOEvaluator

        with open(a.coco_json) as f:
            coco = json.load(f)
        name_to_cat = {c["name"]: c["id"] for c in coco["categories"]}
        img_hw = {im["id"]: (im["height"], im["width"]) for im in coco["images"]}
        gts = []
        with open(a.processed_json) as f:
            for line in f:
                item = json.loads(line)
                h, w = img_hw[item["id"]]
                for obj in item["objects"]:
                    x1, y1, x2, y2 = obj["bbox"]
                    gts.append(
                        {
                            "image_id": item["id"],
                            "category_id": name_to_cat[obj["label"]],
                            "bbox": [round(x1 * w), round(y1 * h), round((x2 - x1) * w), round((y2 - y1) * h)],
                            "area": obj["area"],
                            "iscrowd": obj.get("iscrowd", 0),
                        }
                    )
        dts = []
        for p in preds:
            cat = name_to_cat.get(str(p["category"]).lower())
            if cat is None:
                continue
            dts.append({"image_id": p["image_id"], "category_id": cat, "bbox": p["bbox"], "score": p["score"]})
        stats = COCOEvaluator("bbox").evaluate(gts, dts)
        print(json.dumps(stats, indent=2))
        print(f"\nMean Average Precision (mAP): {stats['AP']:.3f}")
        return stats
    # RefCOCO: AP@0.5 + cIoU (reference eval_refcoco.py:100-134)
    from ..eval.refcoco_eval import score_refcoco

    gts = []
    with open(a.processed_json) as f:
        for line in f:
            item = json.loads(line)
            for obj in item["objects"]:
                x1, y1, x2, y2 = obj["bbox"]
                # GT bbox in px of the ORIGINAL image; rle size gives (h, w)
                h, w = obj["rle"]["size"] if "rle" in obj else (1, 1)
                gts.append(
                    {
                        "image_id": item["id"],
                        "label": obj["label"],
                        "bbox": (x1 * w, y1 * h, (x2 - x1) * w, (y2 - y1) * h),
                        "rle": obj.get("rle"),
                    }
                )
    s = score_refcoco(gts, preds)
    print(json.dumps(s, indent=2))
    return s


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    ai = sub.add_parser("infer")
    ai.add_argument("--model", required=True, help="checkpoint dir, or random:{tiny,3b,7b}")
    ai.add_argument("--data", required=True)
    ai.add_argument("--image_folder", required=True)
    ai.add_argument("--output_dir", default="outputs/eval")
    ai.add_argument("--dataset", default="coco")
    ai.add_argument("--suffix", default="padt")
    ai.add_argument("--batch_size", type=int, default=16)
    ai.add_argument("--max_new_tokens", type=int, default=1024)
    ai.add_argument("--max_side", type=int, default=644)
    ai.add_argument("--device", default="cuda")
    ai.add_argument(
        "--engine", choices=["batch", "stream"], default="batch",
        help="stream = continuous-batching serve engine (slot recycling)",
    )
    ai.add_argument(
        "--share_prefix", action="store_true",
        help="with --engine stream: prefill each unique image once (prefix KV "
        "cache); wins when the dataset has several prompts per image (RefCOCO)",
    )
    ai.add_argument("--n_slots", type=int, default=16)
    ai.add_argument("--prefill_bucket", type=int, default=4)
    ai.add_argument("--chunk_steps", type=int, default=8)
    ai.add_argument(
        "--prompt_bucket", type=int, default=None,
        help="pin ONE prompt bucket (128-multiple) so every chunk reuses one batch shape",
    )
    ai.add_argument(
        "--passes", type=int, default=1,
        help=">1: repeat the dataset on the warm engine; last pass's "
        "infer_dataset_stats is the steady-state throughput",
    )

    asc = sub.add_parser("score")
    asc.add_argument("--task", choices=["coco", "refcoco"], required=True)
    asc.add_argument("--pred_glob", required=True)
    asc.add_argument("--processed_json", required=True)
    asc.add_argument("--coco_json", default=None)
    return ap.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    return cmd_infer(a) if a.cmd == "infer" else cmd_score(a)


if __name__ == "__main__":
    main()
    sys.exit(0)
