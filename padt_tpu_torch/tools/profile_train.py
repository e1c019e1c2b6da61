"""Where a PaDT-3B train step's time goes on the card.

    python3 -m padt_tpu_torch.tools.profile_train [--steps 2] [--unfrozen]

Builds PaDT-3B at full depth and width with random bf16 weights from a
seed, a synthetic REC dataset (46x46-patch images, one box and one RLE mask
per sample) and `PaDTTrainer` in the single-card SFT configuration
(`train_args`: frozen tower, AdamW, batch 8, all four losses; with
`--unfrozen` the tower trains too, with per-block remat). It runs one
step to warm up, `--steps` steps unprofiled for the wall time per step,
then one step under `torch.profiler` (each timed around the step function:
forward, backward and optimizer, the batch already on the card) and
prints: the device's busy time (the kernels' device times summed: one
stream, so they do not overlap), its idle share of the unprofiled and of
the profiled wall, the kernels by device time, and the share
of the port's attention kernels (H1 rope, H2 flash forward, H3 window, H8
dq, H9 dk/dv) and of F8's misaligned MLP GEMMs. Each line names the card
and its power limit. Needs CUDA.

`synthetic_rec`, `train_args` and `flops_per_step` are shared with
chip_smoke.py's [train] phase.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

GRID = (1, 46, 46)  # a 644x644 image in 14px patches
PROMPT_BUCKET = 640  # the REC prompt with the chat template and 529 image pads is 637 tokens
COMPLETION_BUCKET = 64
PATCH_BUCKET = 2304
BATCH = 8
TOP = 14  # kernels listed


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def synthetic_rec(n: int, grid=GRID, seed: int = 0):
    """n REC samples over seeded uint8 images of `grid` patches: each with
    one object, a box of merged patches, its patch ids and its mask as RLE at
    the image's resolution. Returns (dataset rows, ProcessedImages)."""
    from ..eval import rle
    from ..preprocess.vision_process import ProcessedImage

    t, gh, gw = grid
    mh, mw = gh // 2, gw // 2  # merged (28px) grid
    r = np.random.RandomState(seed)
    rows, images = [], []
    for i in range(n):
        hh, ww = r.randint(2, max(3, mh // 3)), r.randint(2, max(3, mw // 3))
        y0, x0 = r.randint(0, mh - hh + 1), r.randint(0, mw - ww + 1)
        mask = np.zeros((gh * 14, gw * 14), np.uint8)
        mask[y0 * 28 : (y0 + hh) * 28, x0 * 28 : (x0 + ww) * 28] = 1
        obj = {
            "patches": [y * mw + x for y in range(y0, y0 + hh) for x in range(x0, x0 + ww)],
            "bbox": [x0 / mw, y0 / mh, (x0 + ww) / mw, (y0 + hh) / mh],
            "rle": rle.encode(mask),
        }
        rows.append({
            "id": i, "image_path": [],
            "problem": f'Please locate "the object number {i}" in the image.',
            "solution": {"text": f'The "object number {i}" refers to <|Obj_0|> in this image.', "objects": [obj]},
        })
        pix = r.randint(0, 256, (t * gh * gw, 3 * 14 * 14)).astype(np.uint8)
        images.append(ProcessedImage(pixel_patches=None, grid_thw=grid, pixel_patches_u8=pix))
    return rows, images


def train_args(output_dir: str, **kw):
    """The single-card PaDT-3B SFT configuration: frozen tower, AdamW at lr
    2e-5 with max grad norm 1.0, batch 8, all four losses, prompt bucket
    640 + completion bucket 64, patch bucket 2304."""
    from ..train.trainer import TrainArgs

    base = dict(
        learning_rate=2e-5, per_device_train_batch_size=BATCH, num_train_epochs=1.0, max_grad_norm=1.0,
        freeze_vision_modules=True, use_mask_loss=True, optimizer="adamw", save_steps=10**9,
        prompt_bucket=PROMPT_BUCKET, completion_bucket=COMPLETION_BUCKET, patch_bucket=PATCH_BUCKET, seed=0,
    )
    base.update(kw)
    return TrainArgs(output_dir=output_dir, **base)


def flops_per_step(cfg, params, batch_size: int, l_total: int, lc: int, s_patches: int, freeze_vision: bool) -> float:
    """Model FLOPs of one train step, as `bench_train.py::_flops_per_step`
    counts them: 2 per matmul weight per token forward, backward twice the
    forward over the trainable text stack, attention score and value
    products added (the text's counted dense, not causal), the tower's
    forward once when frozen."""
    count = lambda tree: sum(t.numel() for t in _leaves(tree))
    tc, vc = cfg.text, cfg.vision
    head = 2 * (tc.vocab_size + cfg.max_merged_patches) * tc.hidden_size * lc
    attn_text = 4 * l_total * l_total * tc.num_attention_heads * tc.head_dim
    text_fwd = 2 * count(params["text"]["layers"]) * l_total + head + attn_text
    n_full = len(vc.fullatt_block_indexes)
    attn_vis = 4 * s_patches * vc.hidden_size * (n_full * s_patches + (vc.depth - n_full) * 64)
    vis_fwd = 2 * count(params["vision"]) * s_patches + attn_vis
    return float((1 if freeze_vision else 3) * vis_fwd + 3 * text_fwd) * batch_size


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def make_trainer(dev, n_samples: int, output_dir: str, params=None, **train_kw):
    """(cfg, trainer) for PaDT-3B (max_objects 8, as the single-card SFT
    setup) on `n_samples` synthetic REC samples; random bf16 weights from
    seed 0 unless `params` is given; `train_kw` overrides `train_args`
    (freeze_vision_modules=False trains the tower). The trainer writes no
    checkpoint."""
    from .. import padt_3b
    from ..models import padt as P
    from ..train.trainer import PaDTTrainer
    from ..utils.mock_tokenizer import make_full_tokenizer
    from ..vrt.processor import VisionTextProcessor

    cfg = padt_3b().replace(max_objects=8)
    if params is None:
        params = P.init_padt_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, torch.bfloat16)
    proc = VisionTextProcessor(make_full_tokenizer(cfg), cfg)
    proc.prepare(cfg.text.vocab_size)
    rows, images = synthetic_rec(n_samples, GRID)
    trainer = PaDTTrainer(cfg, params, proc, train_args(output_dir, **train_kw), rows, images=images, device=dev)
    trainer.save_checkpoint = lambda *a, **k: None  # a 20 GB checkpoint write is not part of a step
    return cfg, trainer


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2, help="unprofiled steps timed after one warm-up step")
    ap.add_argument("--unfrozen", action="store_true", help="train the tower too (TrainArgs' default)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    name = card()
    n_steps = 1 + args.steps + 1
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    records = []  # (ms, profile or None) per step: one warm-up, args.steps timed, one profiled
    with tempfile.TemporaryDirectory() as out:
        cfg, trainer = make_trainer(dev, BATCH * n_steps, out, freeze_vision_modules=not args.unfrozen)
        step_fn = trainer._fn

        def timed(kind, *key):
            fn = step_fn(kind, *key)

            def run(*a):
                last = len(records) == n_steps - 1
                prof = torch.profiler.profile(activities=acts) if last else contextlib.nullcontext()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with prof:
                    res = fn(*a)
                    torch.cuda.synchronize()
                records.append(((time.perf_counter() - t0) * 1e3, prof if last else None))
                return res

            return run

        trainer._fn = timed
        torch.cuda.reset_peak_memory_stats()
        trainer.train()
    walls = [ms for ms, _ in records[1:-1]]
    prof_ms, prof = records[-1]
    by_name = defaultdict(float)
    for evt in prof.key_averages():
        # kernels only: a user annotation (e.g. "Optimizer.step#AdamW.step")
        # also carries device time, that of the kernels under it
        if (evt.device_time_total > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False) and "#" not in evt.key):
            by_name[evt.key] += evt.device_time_total / 1e3  # ms in the profiled step
    busy = sum(by_name.values())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    ours = lambda *names: sum(v for k, v in by_name.items() if "padt::" in k and any(n in k for n in names))
    parts = {
        "H1 rope": ours("rope_qk_kernel"), "H2 flash fwd": ours("segment_flash_kernel"),
        "H3 window": ours("window_slot_kernel"), "H8 dq": ours("fbwd::dq::dq_kernel"),
        "H9 dkv": ours("fbwd::dkv::dkv_kernel"),
    }
    wall = float(np.mean(walls))
    # F8: the tower's MLP GEMMs at ff 3420 (a width that is no multiple of 8 elements) fall to cuBLAS's sm80 "align2"
    # kernels
    f8 = sum(v for k, v in by_name.items() if "align2" in k)
    tower = "tower trained" if args.unfrozen else "tower frozen"
    print(f"[profile_train] 3b batch {BATCH}, L {PROMPT_BUCKET + COMPLETION_BUCKET}, {tower}: wall {wall:.1f} ms/step unprofiled "
          f"(mean of {len(walls)}), {prof_ms:.1f} ms profiled; device busy {busy:.1f} ms: idle {1 - busy / wall:.3f} of the "
          f"unprofiled wall, {1 - busy / prof_ms:.3f} of the profiled one; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"GB allocated ({name})")
    print("[profile_train] attention kernels: " + ", ".join(f"{k} {v:.2f} ms ({v / busy:.3f} of busy)" for k, v in parts.items())
          + f"; F8 (sm80 align2 GEMMs) {f8:.2f} ms ({f8 / busy:.3f} of busy)")
    for k, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"[profile_train] {ms:9.3f} ms  {k[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
