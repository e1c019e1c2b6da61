"""SFT training entry point (the port's counterpart of `scripts/sft_train.py`,
on the port's `PaDTTrainer`).

Rebuilds `src/PaDT/sft_train.py` + the `run_scripts/*.sh` flag surface
(reference `padt_sft_config.py:21-160`): colon-separated data files / image
folders, loss switches, patch-picking flags, resume. One device
(`--device`, default cuda): the mesh flags are kept, and the trainer
refuses sizes other than 1.

Example (PaDT_Pro-style mix):
  python -m padt_tpu_torch.tools.sft_train \
    --model_name_or_path /ckpts/Qwen2.5-VL-3B-Instruct \
    --data_file_paths data/coco_train.jsonl:data/refcoco_train.jsonl \
    --image_folders /data/coco/train2017:/data/coco/train2017 \
    --per_device_train_batch_size 16 --num_train_epochs 4
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_name_or_path", required=True)
    ap.add_argument("--data_file_paths", required=True, help="colon-separated JSONL paths")
    ap.add_argument("--image_folders", required=True, help="colon-separated image roots")
    ap.add_argument("--output_dir", default="outputs/padt_sft")
    ap.add_argument("--learning_rate", type=float, default=2e-5)
    ap.add_argument("--per_device_train_batch_size", type=int, default=16)
    ap.add_argument("--gradient_accumulation_steps", type=int, default=1)
    ap.add_argument("--num_train_epochs", type=float, default=4)
    ap.add_argument("--max_grad_norm", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--save_steps", type=int, default=100)
    ap.add_argument("--logging_steps", type=int, default=1)
    ap.add_argument("--max_pixels", type=int, default=12_845_056)
    ap.add_argument("--min_pixels", type=int, default=3136)
    ap.add_argument("--use_mask_loss", action="store_true", default=False)
    ap.add_argument("--no_bbox_loss", dest="use_bbox_loss", action="store_false", default=True)
    ap.add_argument("--no_score_loss", dest="use_score_loss", action="store_false", default=True)
    ap.add_argument("--no_sft_vp_mask", dest="use_sft_vp_mask", action="store_false", default=True)
    ap.add_argument("--no_warm_up", dest="use_warm_up", action="store_false", default=True)
    ap.add_argument("--random_select_patch", action="store_true", default=False)
    ap.add_argument("--random_select_patch_num", type=int, default=5)
    ap.add_argument("--freeze_vision_modules", action="store_true", default=False)
    ap.add_argument(
        "--cache_vision_features", action="store_true", default=False,
        help="with --freeze_vision_modules: compute each sample's vision-tower "
        "features once and reuse (exact-equivalent; ~10 MB host RAM/sample at 3B)",
    )
    ap.add_argument(
        "--vis_cache_dtype", default="bf16", choices=["bf16", "int8"],
        help="int8: per-row quantized cached features — ~2x smaller cache and "
        "per-step feed; bounded forward perturbation (features are frozen "
        "stop_gradient inputs)",
    )
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--resume_from_checkpoint", default="false")
    ap.add_argument("--mesh_data", type=int, default=1)
    ap.add_argument("--mesh_fsdp", type=int, default=1)
    ap.add_argument("--mesh_tensor", type=int, default=1)
    ap.add_argument("--prompt_bucket", type=int, default=None)
    ap.add_argument("--completion_bucket", type=int, default=None)
    ap.add_argument("--patch_bucket", type=int, default=None)
    ap.add_argument("--val_split_ratio", type=float, default=0.0)
    ap.add_argument("--eval_steps", type=int, default=100)
    ap.add_argument("--per_device_eval_batch_size", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    from ..api import load_model
    from ..train.data import load_jsonl_datasets
    from ..train.trainer import PaDTTrainer, TrainArgs

    cfg, params, processor = load_model(
        a.model_name_or_path, min_pixels=a.min_pixels, max_pixels=a.max_pixels,
        use_mask_head=a.use_mask_loss, device=a.device,
    )
    dataset = load_jsonl_datasets(a.data_file_paths.split(":"), a.image_folders.split(":"))
    eval_dataset = None
    if a.val_split_ratio > 0:
        # seeded shuffled split (reference dataset.train_test_split,
        # sft_train.py:85-90); eval runs every --eval_steps
        import numpy as np

        perm = np.random.RandomState(a.seed).permutation(len(dataset))
        n_val = max(int(len(dataset) * a.val_split_ratio), 1)
        eval_dataset = [dataset[i] for i in perm[:n_val]]
        dataset = [dataset[i] for i in perm[n_val:]]
    print(f"Loaded {len(dataset)} training samples"
          + (f", {len(eval_dataset)} validation samples" if eval_dataset else ""))

    args = TrainArgs(
        learning_rate=a.learning_rate,
        per_device_train_batch_size=a.per_device_train_batch_size,
        gradient_accumulation_steps=a.gradient_accumulation_steps,
        num_train_epochs=a.num_train_epochs,
        max_grad_norm=a.max_grad_norm,
        seed=a.seed,
        save_steps=a.save_steps,
        logging_steps=a.logging_steps,
        output_dir=a.output_dir,
        use_mask_loss=a.use_mask_loss,
        use_bbox_loss=a.use_bbox_loss,
        use_score_loss=a.use_score_loss,
        use_sft_vp_mask=a.use_sft_vp_mask,
        use_warm_up=a.use_warm_up,
        random_select_patch=a.random_select_patch,
        random_select_patch_num=a.random_select_patch_num,
        freeze_vision_modules=a.freeze_vision_modules,
        cache_vision_features=a.cache_vision_features,
        vis_cache_dtype=a.vis_cache_dtype,
        optimizer=a.optimizer,
        prompt_bucket=a.prompt_bucket,
        completion_bucket=a.completion_bucket,
        patch_bucket=a.patch_bucket,
        mesh_data=a.mesh_data,
        mesh_fsdp=a.mesh_fsdp,
        mesh_tensor=a.mesh_tensor,
        eval_strategy="steps" if eval_dataset else "no",
        eval_steps=a.eval_steps,
        per_device_eval_batch_size=a.per_device_eval_batch_size,
    )
    trainer = PaDTTrainer(cfg, params, processor, args, dataset, eval_dataset=eval_dataset, device=a.device)
    trainer.train(resume=str(a.resume_from_checkpoint).lower() == "true")
    return trainer


if __name__ == "__main__":
    main()
    sys.exit(0)
