"""Checkpoint format conversion, both directions (the port's counterpart of
`scripts/convert_checkpoint.py`).

HF -> native (`padt_config.json` + `params.pt`): native checkpoints load
without the transpose pass and carry the PaDTConfig, the reference's "model
carries its decoder config" property (`padt_sft_trainer.py:149-162`).

  python -m padt_tpu_torch.tools.convert_checkpoint --src /ckpts/PaDT_Pro_3B --dst ckpts/padt_pro_3b_native

native/HF -> HF (--to-hf): a deployable HF safetensors checkpoint, the
reference's save-path property (DeepSpeed gather-16bit, `zero3.json:32` +
`sft_train.py:112`), so a model trained here round-trips into the
reference's toolchain. A trainer checkpoint directory is a native source.

  python -m padt_tpu_torch.tools.convert_checkpoint --to-hf --src outputs/sft/checkpoint-900 --dst ckpts/padt_hf

Conversion is host work: the tensors are made on `--device` (default cpu).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import torch

TOKENIZER_HINTS = ("tokenizer", "vocab", "merges", "special_tokens", "chat_template", "preprocessor")


def copy_tokenizer_files(src: str, dst: str) -> None:
    for fname in os.listdir(src):
        if any(k in fname for k in TOKENIZER_HINTS):
            shutil.copy(os.path.join(src, fname), os.path.join(dst, fname))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="source checkpoint dir (HF or native)")
    ap.add_argument("--dst", required=True, help="output dir")
    ap.add_argument("--dtype", default=None, help="torch dtype name to cast to (default bfloat16)")
    ap.add_argument("--to-hf", action="store_true", help="export HF safetensors instead of the native format")
    ap.add_argument("--device", default="cpu", help="device the tensors are made on")
    args = ap.parse_args(argv)

    from ..api import load_model, save_native
    from ..convert.hf_to_padt import load_padt_checkpoint
    from ..convert.padt_to_hf import save_hf_checkpoint

    dtype = getattr(torch, args.dtype) if args.dtype else None
    dst = os.path.abspath(args.dst)
    if args.to_hf:
        # use_mask_head=None: keep whatever the checkpoint config says
        cfg, params, _ = load_model(args.src, dtype=dtype, use_mask_head=None, device=args.device)
        save_hf_checkpoint(dst, params, cfg)
        copy_tokenizer_files(args.src, dst)
        print("wrote HF checkpoint:", dst)
        return 0

    cfg, params = load_padt_checkpoint(args.src, dtype=dtype or torch.bfloat16, device=args.device)
    save_native(dst, cfg, params)
    copy_tokenizer_files(args.src, dst)
    print("wrote", dst)
    return 0


if __name__ == "__main__":
    sys.exit(main())
