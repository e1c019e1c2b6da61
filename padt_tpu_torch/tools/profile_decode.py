"""Where a serve decode step's time goes on the card.

    python3 -m padt_tpu_torch.tools.profile_decode [--model 3b|7b]

Fills every slot of an 8-slot `ServeEngine` pool (int8 KV, packed weights: bf16 for
PaDT-3B, int8 for PaDT-7B, random from a seed; 46x46-patch images, prompt
640), runs one 16-step decode chunk unprofiled for the wall time per step,
then one under `torch.profiler` and prints, per step: the device's busy time (the
kernels' device times summed: one stream, so they do not overlap), its idle
share of the profiled wall, the kernels by device time, and the share of
H7 (`int8_matmul`), of the attention kernels and of H1 (`rope_qk`). Each line names the card
and its power limit. Needs CUDA.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

PROMPT_LEN = 640
GRID = (1, 46, 46)
PATCHES = 2304
SLOTS = 8
STEPS = 16  # decode steps per chunk
TOP = 12  # kernels listed


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def _engine(model: str, dev):
    from .. import padt_3b, padt_7b
    from ..eval.harness import InferenceEngine
    from ..models import padt as P
    from ..preprocess.vision_process import ProcessedImage
    from ..serve import ServeEngine
    from ..utils.mock_tokenizer import make_full_tokenizer
    from ..vrt.processor import VisionTextProcessor

    gen = torch.Generator(device=dev).manual_seed(0)
    if model == "7b":
        cfg = padt_7b()
        params = P.init_padt_params_quantized(cfg, gen, dev, torch.bfloat16, packed=True)
    else:
        cfg = padt_3b()
        params = P.init_padt_params(cfg, gen, dev, torch.bfloat16)
    proc = VisionTextProcessor(make_full_tokenizer(cfg), cfg)
    proc.prepare(cfg.text.vocab_size)
    t, gh, gw = GRID
    images = [
        ProcessedImage(None, GRID, np.random.RandomState(i).randint(0, 256, (t * gh * gw, 588)).astype(np.uint8))
        for i in range(SLOTS)
    ]
    prompts = [f'Please locate "the object number {i}" in the image.' for i in range(SLOTS)]
    reqs, _ = InferenceEngine(params, cfg, proc).build_stream_requests(prompts, images, prompt_bucket=PROMPT_LEN)
    budget = 2 * STEPS + 4
    for q in reqs:
        q.max_new_tokens = budget
    eng = ServeEngine(params, cfg, n_slots=SLOTS, max_new_tokens=budget, prompt_len=PROMPT_LEN,
                      prefill_bucket=SLOTS, patch_bucket=PATCHES)
    return eng, reqs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("3b", "7b"), default="7b")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = _card()
    eng, reqs = _engine(args.model, dev)
    ctx = eng.start_run(reqs)
    eng._refill(ctx)  # prefill every slot
    eng._chunk(2)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._chunk(STEPS)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._chunk(STEPS)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    if int(eng.state.n_gen.min()) < 2 + 2 * STEPS:
        raise AssertionError("a slot stopped before the profiled chunk ended")

    by_name = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_time_total > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] += evt.device_time_total / 1e3 / STEPS  # ms per step
    busy = sum(by_name.values())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    ours = lambda *names: sum(v for k, v in by_name.items() if "padt::" in k and any(n in k for n in names))
    h7 = ours("gemm_kernel<true")  # gemm_sm90.cuh's int8 instances (H10's are gemm_kernel<false, ...>)
    attn = ours("decode_kernel", "verify_kernel")  # H4 / H5 (csrc/int8_kv.cu)
    rope = ours("rope_qk_kernel")  # H1 (csrc/rope_qk.cu): one launch per layer of a step
    tag = f"{args.model} {SLOTS} slots"
    print(f"[profile] {tag}: wall {wall_ms:.3f} ms/step unprofiled, {prof_ms:.3f} ms/step profiled; "
          f"device busy {busy:.3f} ms/step, idle {1 - busy / prof_ms:.3f} of the profiled wall; "
          f"H7 int8_matmul {h7:.3f} ms/step ({h7 / busy:.3f} of busy); H4 attention {attn:.3f} ms/step "
          f"({attn / busy:.3f} of busy); H1 rope {rope:.3f} ms/step ({rope / busy:.3f} of busy) ({card})")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[: TOP]:
        print(f"[profile] {tag}: {ms:8.4f} ms/step  {name[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
