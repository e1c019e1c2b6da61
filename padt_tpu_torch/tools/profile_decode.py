"""Where a serve decode step's time goes on the card.

    python3 padt_tpu_torch/tools/profile_decode.py [--model 3b|7b] [--root DIR]

Fills every slot of a 32-slot `ServeEngine` pool, the benchmark's (int8 KV,
packed weights: bf16 for PaDT-3B, int8 for PaDT-7B, random from a seed;
46x46-patch images, prompt 640), runs eight 16-step decode chunks unprofiled, every other one inside
`utils.profiling.recording()`, and prints per step the wall time and the
host's split from the program's spans (`[host]`): `decode.step` less the
waits inside it (launching the step) by child (`decode.logits`,
`decode.layers`, `decode.store`), and the `decode.*readback` spans (waiting
on the device), and what recording the span list costs the host. Then it runs one chunk under `torch.profiler` and
prints, per step: the device's busy time (the
kernels' device times summed: one stream, so they do not overlap), its idle
share of the profiled wall, the kernels by device time, the share of
H7 (`int8_matmul`), of the attention kernels and of H1 (`rope_qk`), and
"H6 + row stacks": H6's (`store_kv_rows`) device time and that of the
`torch.stack` calls of the step (older trees stacked every layer's new rows
for H6; this one quantizes them into one stacked buffer). Each line names
the card and its power limit. Needs CUDA.

`--root` imports `padt_tpu_torch` from DIR (default: this checkout), so one
call on the card can profile an older tree (unpacked with `git archive`
into a directory that .gitignore lists) beside this one.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

PROMPT_LEN = 640
GRID = (1, 46, 46)
PATCHES = 2304
SLOTS = 32  # the pool of the benchmark's refcoco_stream cells
STEPS = 16  # decode steps per chunk
TOP = 12  # kernels listed


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def _engine(model: str, dev):
    import torch

    from padt_tpu_torch import padt_3b, padt_7b
    from padt_tpu_torch.eval.harness import InferenceEngine
    from padt_tpu_torch.models import padt as P
    from padt_tpu_torch.preprocess.vision_process import ProcessedImage
    from padt_tpu_torch.serve import ServeEngine
    from padt_tpu_torch.utils.mock_tokenizer import make_full_tokenizer
    from padt_tpu_torch.vrt.processor import VisionTextProcessor

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
    budget = 10 * STEPS
    for q in reqs:
        q.max_new_tokens = budget
    eng = ServeEngine(params, cfg, n_slots=SLOTS, max_new_tokens=budget, prompt_len=PROMPT_LEN,
                      prefill_bucket=SLOTS, patch_bucket=PATCHES)
    return eng, reqs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("3b", "7b"), default="7b")
    ap.add_argument("--root", default=None, help="import padt_tpu_torch from this directory")
    args = ap.parse_args()
    root = os.path.abspath(args.root or os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs an NVIDIA GPU")
    import padt_tpu_torch

    where = os.path.relpath(os.path.dirname(padt_tpu_torch.__file__), os.getcwd())
    dev = torch.device("cuda", 0)
    card = _card()
    eng, reqs = _engine(args.model, dev)
    from padt_tpu_torch.utils import profiling

    ctx = eng.start_run(reqs)
    eng._refill(ctx)  # prefill every slot
    eng._chunk(2, profiling.Recorder())  # warm
    tag = f"{args.model} {SLOTS} slots ({where})"

    walls, recs = {False: [], True: []}, {False: [], True: []}
    for on in (False, True) * 4:  # recording the span list off and on, in turns
        rec = profiling.Recorder()
        with profiling.recording() if on else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._chunk(STEPS, rec)
            torch.cuda.synchronize()
        walls[on].append((time.perf_counter() - t0) * 1e3 / STEPS)
        recs[on].append(rec)
    wall_ms = float(np.mean(walls[False]))
    ms = lambda on, name: float(np.mean([r.sums.get(name, 0) for r in recs[on]])) / 1e6 / STEPS
    waits = {n for r in recs[False] for n in r.sums if n.startswith("decode.") and n.endswith("readback")}
    readback = sum(ms(False, n) for n in waits)
    step = ms(False, "decode.step")
    launch = step - sum(ms(False, n) for n in waits if n != "decode.readback")  # less the waits inside a step
    kids = {n: ms(False, "decode." + n) for n in ("logits", "layers", "store")}
    host = lambda on: ms(on, "decode.step") + ms(on, "decode.readback")
    print(f"[host] {tag}: wall {wall_ms:.3f} ms/step; launch {launch:.3f} ms/step (decode.step {step:.3f} = "
          + ", ".join(f"{n} {v:.3f}" for n, v in kids.items())
          + f", other {step - sum(kids.values()):.3f}); readback (decode.*readback) {readback:.3f} "
          f"ms/step; recording the span list: host {host(True):.3f} against {host(False):.3f} ms/step, "
          f"wall {np.mean(walls[True]):.3f} against {wall_ms:.3f} ms/step ({card})")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prec = profiling.Recorder()  # under the profiler its spans are annotations on the device's timeline too
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._chunk(STEPS, prec)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    if int(eng.state.n_gen.min()) < 2 + 9 * STEPS:
        raise AssertionError("a slot stopped before the profiled chunk ended")

    by_name = defaultdict(float)
    stack_ms, stack_calls = 0.0, 0
    for evt in prof.key_averages():
        if evt.key in prec.counts:  # a program span, not a kernel
            continue
        if evt.device_time_total > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] += evt.device_time_total / 1e3 / STEPS  # ms per step
        elif evt.key == "aten::stack":  # a host op: the device time of the kernels it launched
            stack_ms += evt.device_time_total / 1e3 / STEPS
            stack_calls += evt.count
    busy = sum(by_name.values())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    ours = lambda *names: sum(v for k, v in by_name.items() if "padt::" in k and any(n in k for n in names))
    h7 = ours("gemm_kernel<true")  # gemm_sm90.cuh's int8 instances (H10's are gemm_kernel<false, ...>)
    attn = ours("decode_kernel", "verify_kernel")  # H4 / H5 (csrc/int8_kv.cu)
    rope = ours("rope_qk_kernel")  # H1 (csrc/rope_qk.cu): one launch per layer of a step
    store = ours("store_rows")  # H6 (csrc/int8_kv.cu): one launch per step
    print(f"[profile] {tag}: wall {wall_ms:.3f} ms/step unprofiled, {prof_ms:.3f} ms/step profiled; "
          f"device busy {busy:.3f} ms/step, idle {1 - busy / prof_ms:.3f} of the profiled wall; "
          f"H7 int8_matmul {h7:.3f} ms/step ({h7 / busy:.3f} of busy); H4 attention {attn:.3f} ms/step "
          f"({attn / busy:.3f} of busy); H1 rope {rope:.3f} ms/step ({rope / busy:.3f} of busy) ({card})")
    print(f"[profile] {tag}: H6 + row stacks {store + stack_ms:.4f} ms/step (H6 {store:.4f}, stacks {stack_ms:.4f} "
          f"over {stack_calls / STEPS:g} torch.stack calls a step) ({card})")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[: TOP]:
        print(f"[profile] {tag}: {ms:8.4f} ms/step  {name[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
