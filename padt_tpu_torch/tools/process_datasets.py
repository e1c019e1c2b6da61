"""Dataset preprocessing CLI (reference `src/preprocess/*` entry points); the
port's counterpart of `scripts/process_datasets.py`.

  python -m padt_tpu_torch.tools.process_datasets coco --input instances_val2017.json --output out.jsonl [--train]
  python -m padt_tpu_torch.tools.process_datasets refcoco --data_root dataset/RefCOCO --dataset refcoco --split val --output out.jsonl
  python -m padt_tpu_torch.tools.process_datasets ric --input captions.json --output out.jsonl
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("coco")
    c.add_argument("--input", required=True)
    c.add_argument("--output", required=True)
    c.add_argument("--train", action="store_true")
    c.add_argument("--max_per_class", type=int, default=50)
    c.add_argument("--seed", type=int, default=None)

    r = sub.add_parser("refcoco")
    r.add_argument("--data_root", required=True)
    r.add_argument("--dataset", default="refcoco", choices=["refcoco", "refcoco+", "refcocog"])
    r.add_argument("--split", default="val")
    r.add_argument("--output", required=True)

    i = sub.add_parser("ric")
    i.add_argument("--input", required=True)
    i.add_argument("--output", required=True)

    a = ap.parse_args(argv)
    if a.cmd == "coco":
        from ..preprocess.datasets import process_coco

        stats = process_coco(a.input, a.output, max_bboxes_per_class_per_image=a.max_per_class,
                             is_train=a.train, seed=a.seed)
    elif a.cmd == "refcoco":
        from ..preprocess.refer_api import process_refcoco

        stats = process_refcoco(a.data_root, a.dataset, a.split, a.output)
    else:
        from ..preprocess.datasets import process_ric

        stats = process_ric(a.input, a.output)
    print(stats)
    return stats


if __name__ == "__main__":
    main()
    sys.exit(0)
