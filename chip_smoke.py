#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`padt_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `padt_tpu_torch/csrc` (nvcc, sm_90a,
one process per source, into build/padt_tpu_torch/), then:
  1. prints the card (nvidia-smi name and power limit, torch device name);
  2. holds each kernel against its plain PyTorch twin at the shapes the main
     paths give it, PaDT-3B's and PaDT-7B's (bf16 attention outputs: max abs
     error over all rows, tolerance 2e-2, bf16 output rounding plus a
     different order of sums; H4's QI8 mode and H1: also one bf16 ulp of
     the largest output, and for QI8 a mean gap from its twin at most a
     quarter of its gap from the bf16-score twin; the int8 row store:
     byte-identical), and times
     the kernel, the twin and, where one exists, the one PyTorch call that
     computes the same function, with CUDA events, beside the kernel's bound
     (the larger of its bytes over 3.35 TB/s and its operations over the
     peak rate of their type); the int8 KV forms beside the serve path's
     (K13-K18, H4 without its fresh column or with n_valid, H5 with the
     causal limit, H6 into one layer) and H4's int8 x int8 score mode
     (PADT_DECODE_QI8) among them, and H5 at the speculative verify's kq =
     4 beside the suffix pass's 32; H2's vision lines are held to 2e-2 of
     their largest output; H8 / H9 each output to 2e-2 of its own largest
     value and to a relative norm gap of 1e-2, as are H7's and H10's lines,
     every H4 / H5 line (QI8 to its one ulp and the same norm gap) and H3's;
     H1 at every shape its paths run, each line's launches those at its own
     shape (rows and heads: the vision tower of run_batch and of the train
     step, run_batch's prefill and decode steps, the serve pool's and
     PaDT-7B's decode steps, the train step's VJP); each line prints the
     kernel's share of its bound; [gqa]: H2 at its GQA shapes
     against one kv head per query head, warm and from HBM (logged); [ptxas]:
     the registers and spill bytes of every H8 / H9 instance, every H7 /
     H10 GEMM instance, every H4 / H5 instance, every H1 / H3 instance and
     H6 from the build's ptxas report (a spill fails the run, and so does an
     H4 / H5 / H3 instance with no tensor-core product in its SASS: HMMA
     and, for QI8, IMMA in H4, HGMMA in H5 and H3); [bwd]: per shape, H8 + H9 against SDPA's whole backward; the
     trained tower's kernels at its 8 x 2304 (H2 with its LSE and H8 /
     H9 over seg_full and over the slot ids seg_win, q/k/v views of the
     fused qkv), and H8 / H9 at 2 x 2304, where they were first timed, as
     yardsticks;
     [moe]: H11, the grouped expert GEMM (csrc/expert_matmul.cu), against its
     twin at Keye-VL-2.0-30B-A3B's widths at a 32-slot decode step (256
     choices) and a 4 x 640 admission (20480 choices), timed beside its
     bound;
     [tower-mlp]: one PaDT-3B tower block's MLP at 4 x 2304 rows as the
     block runs it, plain (ff 3420) and packed at 3424 and at 3456 (each
     against the plain one), device ms beside the three products' bound, and
     the library GEMMs each form launches; H12 (the packed SwiGLU) against
     its twin at 4 x 2304 rows of the port's width (3424) and a ragged row
     count, launched on the serve path (32 a tower);
  3. [forms]: drives the older forms through `ops.kv_cache` (store-then-
     attend over the 36 layers, unstacked and layer=, n_valid) with the
     launch counters reset before and read after, exact launches, and holds
     them against the serve path's fresh forms;
  4. checks the vision tower, bf16 prefill, int8 prefill, one int8 suffix
     pass, one int8 decode step and one QI8 decode step of a tiny model on
     the card against the plain float32 CPU path, with dense bf16 weights and
     again with int8 weights (`quantize_params` + `pack_inference_params` run
     on the card, every text-layer product through H7), the QI8 step's
     greedy tokens equal wherever the CPU's top-2 margin exceeds the logit
     error; then `padt_loss` with its gradients (all four losses, the tower
     frozen and then trained, H9 in every text layer and tower block) on
     the card in bf16 against the float32 CPU path (loss within 5e-2
     relative, each trainable leaf's gradient, every tower leaf's
     included, within 0.1 in relative norm, the whole gradient's cosine at
     least 0.995);
  5. runs PaDT-3B REC inference through `InferenceEngine.run_batch` (random
     weights from a seeded generator, 4 prompts over 644px-class images of
     46x46 patches, 32 new tokens, bf16 KV) with the launch counters reset
     just before and read just after, runs `vl_decode` on 4 forced objects,
     checks every output is finite and of the expected shape, and times
     vision, prefill and decode;
  6. serves PaDT-3B through the continuous-batching engine (int8 KV, packed
     weights, 8 slots): `run_stream` of 16 REC requests, `ServeEngine.run`
     with budgets of 8..32 tokens, `run_stream(share_prefix=True)` of 8
     prompts over 2 images, and a speculative=4 engine run, with the launch
     counters reset just before and read just after; checks the outputs and
     the launch floors (H5's split by kq: 36 per speculative verify pass at
     kq = 4, 36 per suffix pass at kq = 32), and prints wall, device prefill
     / decode seconds, decode tok/s and slot utilization. A plain decode
     step after an engine's capture replays its CUDA graph, so from there
     on the serve counts (here and in steps 7, 8 and 10) are the captured
     step's, added once a replay (`serve.engine.Graphs`);
     `tests/test_torch_decode_graph.py` holds the kernels a profiler trace
     of a replay names against an eager step's;
  7. [qi8]: the same weights with PADT_DECODE_QI8's int8 x int8 decode
     scores: int8 `generate` of 4 queries (first without QI8) and
     `run_stream` of 16 requests over 8 slots (step 6's first run is the one
     without); exact QI8 launches (36 per decode step), finite outputs, the
     greedy tokens' agreement printed;
  8. [pipeline]: the released-checkpoint path on the same weights:
     `save_hf_checkpoint` (two 4 GiB shards + index, bf16),
     `tools/convert_checkpoint` HF -> native, `api.load_model` of each
     directory onto the card (every leaf bit-equal to the phase 5 weights by
     key, dtype and device), `run_batch` on the loaded weights (completions
     equal to phase 5's, H1-H3 at their floors) and `run_stream` of 8
     requests (H4 and H6 at their floors), each with the counters reset just
     before and read just after; then `tools/infer_eval.py infer` over 8
     PNGs the phase writes (PIL imports on the card) and `score` as COCO and
     RefCOCO against the ground truth it writes (printed); prints the GB and
     seconds of the export, the conversion and each load; the temporary
     directories are removed in a `finally`;
  9. [train]: trains PaDT-3B through `PaDTTrainer.train()` for 4 steps on
     the same (random, seeded) weights: frozen tower, AdamW (lr 2e-5, max
     grad norm 1.0), batch 8 of a synthetic 32-sample REC dataset (46x46
     patches, one box and one RLE mask each), prompt bucket 640 +
     completion bucket 64, all four losses; with the launch counters reset
     before and read after, it checks the exact launches per step (H8 = H9
     = 36, H2 and H1 for the forward, the checkpoint recompute and H1's
     VJP, and the frozen tower), finite positive loss and grad norm, every
     trainable text leaf moved (or, for the norm weights of 1.0 that an
     update this small cannot move in bf16, reached by a gradient), the
     tower bitwise unchanged, and prints s/step, tokens/s, MFU and peak
     memory; then [train-tower]: 3 more steps on the same weights with
     the tower trained (TrainArgs' default; AdamW, per-block remat): exact
     launches per step (H1 3, H2 2, H8 and H9 once in every text layer and
     tower block, the decoder's 12 H1, no H3), finite positive losses and
     grad norms, every tower leaf moved (or, a bf16 one, reached by a
     gradient), peak memory under 80 GB; prints s/step, tokens/s, MFU
     (the tower counted 3x) and the peak;
  10. [7b]: frees PaDT-3B, builds PaDT-7B at full depth and width with int8
     packed text-layer weights on the card (`init_padt_params_quantized`,
     seeded), holds H7 against its twin at the 7B products' shapes (M = 4
     and 8 decode rows, M = 2560 prefill rows, walking the 28 layers' weights),
     then runs `run_batch` of 4 REC queries (bf16 KV) and `run_stream` of 16
     requests (int8 KV, 8 slots, bucket 4, prompt 640, 32 new tokens), each
     with the launch counters reset before and read after, checks the
     outputs and the launch floors, and prints the times and H7's launches
     split by M;
 11. [stream]: `tools/micro_stream_matmul.py` at PaDT-3B, B = 96, 36 layers
     (torch, H10 with the norms fused, H10 without): device ms and GB/s per
     pass, exactly 4 x 36 H10 launches per pass, each output as close to the
     float32 loop as twice the torch variant's; then H10's kernel lines at
     the four products, fused and unfused;
 12. prints the yardstick lines' JSON (shapes no path runs: H2 over
     seg_win and H8 / H9 over seg_full and seg_win at 2 x 2304, H8 / H9 at
     PaDT-7B's heads, H1 at earlier PRs' shapes; launches 0), the kernels'
     JSON line, then the result line
     {"ok": true, "device": {...}} last.
Any failure raises, and the script exits non-zero without the result line.
It needs CUDA; it imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 2e-2  # bf16 outputs of magnitude ~1: output rounding + sum order
NORM_TOL = 1e-2  # H7-H10: ||kernel - twin|| / ||twin|| of each output (bf16 rounding of the output, of p and ds)
APART = 0.25  # a mode's kernel: its mean abs gap from its twin at most this share of its gap from another mode's twin
TINY_REL_TOL = 5e-2  # tiny model in bf16 with kernels vs float32 plain path
TINY_GRAD_REL_TOL = 0.1  # each trainable leaf's gradient, relative norm, bf16 card vs float32 CPU
TINY_GRAD_COS = 0.995  # cosine of the whole gradient, bf16 card vs float32 CPU
TRAIN_STEPS = 4
TRAIN_TOWER_STEPS = 3  # [train-tower]: steps with the tower trained
TRAIN_BATCH, TRAIN_LEN = 8, 640 + 64  # the train step: prompt bucket 640 + completion bucket 64
GRID = (1, 46, 46)  # a 644x644 image in 14px patches
PATCHES = 2304
PROMPT_LEN = 640
NEW_TOKENS = 32
BATCH = 4
SERVE_SLOTS = 8  # decode slots of the serve pool
SERVE_REQUESTS = 16
SERVE_BUCKET = 4  # requests per admission (prefill) bucket
KV_SLOTS, KV_CAP = 16, 768  # int8 kernel lines: a 16-slot pool, capacity 640 + 32 rounded to 128
SUFFIX_K = 32  # rows of a suffix pass (H5's kq, H6's widest store)
SPEC_K = 4  # the speculative engine's draft_k: H5's kq in a verify pass
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_TENSOR_FLOPS = 989e12  # dense bf16 tensor-core peak
INT8_TENSOR_OPS = 1979e12  # dense int8 tensor-core peak
FP32_FLOPS = 67e12  # fp32 outside the tensor cores
L2_WALK_BYTES = 150e6  # weight bytes a timing walk cycles through: three times the 50 MB L2


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=10, warmup=2, hide_host=True):
    """Mean ms per call between CUDA events around `iters` calls. With
    hide_host, the stream first spins ~20 ms on the GPU, so the host queues
    every call before the device reaches them: the reading is device time,
    not Python and launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hide_host:
        torch.cuda._sleep(40_000_000)  # cycles; ~20 ms at the H100's ~1.98 GHz boost clock
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def bound_ms(n_bytes, ops, peak):
    """(ms, "bytes" or "operations"): the least time of the work on the card,
    its bytes over the HBM rate or its operations over `peak`, whichever is
    larger. `ops` and `peak` may be tuples, one entry per type of operation
    (the int8 x int8 scores beside the bf16 P.V)."""
    if not isinstance(ops, tuple):
        ops, peak = (ops,), (peak,)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, sum(o / p for o, p in zip(ops, peak))
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bf16_ulp(x):
    """The spacing of bf16 numbers (8 significant bits) at magnitude x > 0."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def mean_abs_gap(a, b):
    return (a.float() - b.float()).abs().mean().item()


def worst_gap(a, ref):
    """(share of elements of `a` that differ from `ref`, ref's value where
    the gap is largest, that gap in bf16 ulps of that value)."""
    d = (a.float() - ref.float()).abs().flatten()
    i = int(d.argmax())
    at = abs(ref.float().flatten()[i].item())
    return (d > 0).float().mean().item(), at, d[i].item() / bf16_ulp(max(at, 2.0**-126))


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(f"[device] torch: {name}, count {torch.cuda.device_count()}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    return name, smi


def _visible_pairs(q_seg, k_seg, causal):
    """(query, key) pairs the attention kernels score: segments equal and
    the key's segment >= 0 (and key <= query when causal)."""
    m = (q_seg[:, :, None] == k_seg[:, None, :]) & (k_seg[:, None, :] >= 0)
    if causal:
        m &= torch.ones(m.shape[1:], dtype=torch.bool, device=m.device).tril()
    return int(m.sum()), m


def _sdpa(q, k, v, mask, scale, gqa=False):
    """The one PyTorch call for the attention yardstick: (B, S, H, hd) views
    in, boolean mask (B, 1, Sq, Sk). It differs from the kernels on a row
    with no visible key (NaN there, 0 in the kernels), so it is timed only."""
    import torch.nn.functional as F

    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale, enable_gqa=gqa)


def measure(cases, card):
    """Each case: its kernel vs its twin (max abs error within tol), then the
    kernel, the twin and the library call timed. Returns the JSON entries."""
    entries = []
    for c in cases:
        out, ref = c["kern"](), c["plain"]()
        torch.cuda.synchronize()
        if "view" in c:  # what of the outputs is compared
            out, ref = c["view"](out), c["view"](ref)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        refs = ref if isinstance(ref, (tuple, list)) else (ref,)
        # each output against its own largest value, so a small output (dk beside dv) is not held to the other's
        errs = [(a.float() - r.float()).abs().max().item() for a, r in zip(outs, refs)]
        tops = [r.float().abs().max().item() for r in refs]
        rel = c.get("relative", False)  # one flag, or one per output
        rel = rel if isinstance(rel, tuple) else (rel,) * len(tops)
        tols = [c["tol"] * (t if r else 1.0) for t, r in zip(tops, rel)]
        if c.get("ulp"):  # and one bf16 ulp of the largest output: the kernel rounds as its twin does
            tols = [min(tol, bf16_ulp(t)) for tol, t in zip(tols, tops)]
        for i, (e, t) in enumerate(zip(errs, tols)):
            if not e <= t:
                raise AssertionError(f"{c['name']} [{c['shape']}]: output {i}: max abs err {e} > {t}")
        err, tol_txt = max(errs), " / ".join(f"{e:.3e} (tol {t:.3e})" for e, t in zip(errs, tols))
        if c.get("norm"):  # and the whole output: errors in the small late keys and rows count too
            gaps = [((a.float() - r.float()).norm() / r.float().norm().clamp(min=1e-30)).item() for a, r in zip(outs, refs)]
            tol_txt += ", relative norm gap " + " / ".join(f"{x:.3e}" for x in gaps) + f" (tol {NORM_TOL:.0e})"
            if not all(x <= NORM_TOL for x in gaps):
                raise AssertionError(f"{c['name']} [{c['shape']}]: relative norm gaps {gaps} > {NORM_TOL}")
        if "apart" in c:  # a twin of another mode, which the kernel must not be mistaken for
            near, far = mean_abs_gap(outs[0], refs[0]), mean_abs_gap(outs[0], c["apart"]())
            differ, at, ulps = worst_gap(outs[0], refs[0])
            log(f"[kernel] {c['name']}: mean abs gap {near:.3e} from its twin, {far:.3e} from the {c['apart_name']}; "
                f"{differ:.4f} of the outputs differ from the twin; the largest gap is {ulps:.2f} bf16 ulp of the "
                f"twin's {at:.4e} there")
            if not near <= APART * far:
                raise AssertionError(f"{c['name']}: as close to the {c['apart_name']} ({far}) as to its twin ({near})")
        ms, plain_ms = cuda_ms(c["kern"]), cuda_ms(c["plain"])
        lib_ms = cuda_ms(c["library"]) if c.get("library") else None  # a yardstick: the port never calls it
        b_ms, b_by = bound_ms(*c["bound"])
        lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        log(f"[kernel] {c['name']} [{c['shape']}]: max_abs_err {tol_txt}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library {lib_txt}, bound {b_ms:.4f} ms ({b_by}), "
            f"kernel at {b_ms / ms:.3f} of its bound ({card})")
        entries.append({
            "name": c["name"], "route": "cuda", "source": f"padt_tpu_torch/csrc/{c['source']}",
            "replaces": c["replaces"], "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "shape": c["shape"], "path": c["path"],
            "launch_key": c.get("launch_key", c["name"]),
        })
    return entries


def _int8_attn_cases(dev, g, rnd, nl, slots, hkv, gq, hd, cap, path, tag, with_verify):
    """H4 (and H5) over an int8 cache of `nl` layers that the calls walk in
    turn, one per call, as a decode step does: the cache cycles through the
    50 MB L2, so each call reads its layer from HBM, as on the main path;
    then H6's decode store (and its suffix store)."""
    from padt_tpu_torch.ops import cuda_kv as K

    i8 = lambda *shape: torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
    sc = lambda *shape: torch.exp(torch.randn(shape, generator=g, device=dev) * 0.4 - 4.0)
    kv = lambda *lead: (i8(*lead, hd), sc(*lead), i8(*lead, hd), sc(*lead))  # (k8, ks, v8, vs)
    cache = kv(nl, slots, hkv, cap)
    lens = torch.randint(PROMPT_LEN - 100, cap - SUFFIX_K, (slots,), generator=g, device=dev)
    valid = torch.arange(cap, device=dev)[None, :] < lens[:, None]
    valid[:, :40] = False  # left padding
    live = valid.sum(dim=1)
    fresh1, fresh32, fresh4 = kv(slots, hkv, 1), kv(slots, hkv, SUFFIX_K), kv(slots, hkv, SPEC_K)
    qd, qv, qs = rnd(slots, hkv, gq, hd), rnd(slots, hkv, gq * SUFFIX_K, hd), rnd(slots, hkv, gq * SPEC_K, hd)
    rows1, rows32 = kv(nl, slots, hkv, 1), kv(nl, slots, hkv, SUFFIX_K)
    pos = lens.int()
    one = torch.ones(slots, dtype=torch.int32, device=dev)
    n32 = torch.randint(0, SUFFIX_K + 1, (slots,), generator=g, device=dev, dtype=torch.int32)
    n32[:2] = torch.tensor([0, SUFFIX_K], dtype=torch.int32, device=dev)
    kbuf, pbuf = [t.clone() for t in cache], [t.clone() for t in cache]  # the stores write in place
    layer_bytes = nbytes(*cache) // nl

    def walk(fn, *head, tail=()):
        """fn(*head, layer, *tail) over layers 0, 1, ...: the kernel's and the
        twin's first calls (the comparison) both read layer 0."""
        nxt = itertools.cycle(range(nl)).__next__
        return lambda: fn(*head, nxt(), *tail)

    def store(fn, buf, rows, n):
        return lambda: (fn(*buf, *rows, pos, n), buf)[1]

    def store_bytes(n_rows):  # each written row read from the new rows once and written once
        return 2 * int(n_rows.sum()) * nl * hkv * (2 * hd + 8)

    attn_ops = lambda q_rows, cols: 4 * hd * hkv * q_rows * cols  # QK and PV: int8 is exact in bf16, so bf16 tensor cores
    cases = [dict(
        name="int8_decode_attn", path=path, source="int8_kv.cu", replaces="padt_tpu/ops/kv_cache.py:206", tol=TOL,
        relative=True, norm=True, shape=f"{tag}decode {slots} slots x {hkv} kv heads x {gq} q x{hd}, int8 cache {nl}x{cap} (layers in turn), 1 fresh column",
        kern=walk(K.int8_decode_attn, qd, *cache, *fresh1, valid), plain=walk(K.int8_decode_attn_plain, qd, *cache, *fresh1, valid),
        bound=(layer_bytes + nbytes(qd, *fresh1, valid) + nbytes(qd), attn_ops(gq, int(live.sum()) + slots), BF16_TENSOR_FLOPS),
    )]
    if with_verify:
        cases.append(dict(
            name="int8_verify_attn", path=path, source="int8_kv.cu", replaces="padt_tpu/ops/kv_cache.py:402", tol=TOL,
            relative=True, norm=True, launch_key=f"int8_verify_attn kq={SUFFIX_K}", shape=f"{tag}suffix pass {slots} slots x {hkv} kv heads x ({gq}x{SUFFIX_K}) q x{hd}, int8 cache {nl}x{cap} (layers in turn), {SUFFIX_K} fresh columns",
            kern=walk(K.int8_verify_attn, qv, *cache, *fresh32, valid, tail=(SUFFIX_K,)),
            plain=walk(K.int8_verify_attn_plain, qv, *cache, *fresh32, valid, tail=(SUFFIX_K,)),
            bound=(layer_bytes + nbytes(qv, *fresh32, valid) + nbytes(qv),
                   attn_ops(gq * SUFFIX_K, int(live.sum())) + attn_ops(gq, slots * SUFFIX_K * (SUFFIX_K + 1) // 2), BF16_TENSOR_FLOPS),
        ))
        cases.append(dict(
            name="int8_verify_attn", path=path, source="int8_kv.cu", replaces="padt_tpu/ops/kv_cache.py:402", tol=TOL,
            relative=True, norm=True, launch_key=f"int8_verify_attn kq={SPEC_K}",
            shape=f"{tag}speculative verify {slots} slots x {hkv} kv heads x ({gq}x{SPEC_K}) q x{hd}, int8 cache {nl}x{cap} (layers in turn), {SPEC_K} fresh columns",
            kern=walk(K.int8_verify_attn, qs, *cache, *fresh4, valid, tail=(SPEC_K,)),
            plain=walk(K.int8_verify_attn_plain, qs, *cache, *fresh4, valid, tail=(SPEC_K,)),
            bound=(layer_bytes + nbytes(qs, *fresh4, valid) + nbytes(qs),
                   attn_ops(gq * SPEC_K, int(live.sum())) + attn_ops(gq, slots * SPEC_K * (SPEC_K + 1) // 2), BF16_TENSOR_FLOPS),
        ))
    cases.append(dict(
        name="store_kv_rows", path=path, source="int8_kv.cu", replaces="padt_tpu/ops/kv_cache.py:750", tol=0.0,
        shape=f"{tag}decode store: 1 row per slot x {nl} layers x {slots} slots x {hkv} kv heads, capacity {cap}",
        kern=store(K.store_kv_rows, kbuf, rows1, one), plain=store(K.store_kv_rows_plain, pbuf, rows1, one),
        bound=(store_bytes(one), 0, FP32_FLOPS),
    ))
    if with_verify:
        cases.append(dict(
            name="store_kv_rows", path=path, source="int8_kv.cu", replaces="padt_tpu/ops/kv_cache.py:856", tol=0.0,
            shape=f"{tag}suffix store: n_rows in [0, {SUFFIX_K}] per slot x {nl} layers x {slots} slots x {hkv} kv heads",
            kern=store(K.store_kv_rows, kbuf, rows32, n32), plain=store(K.store_kv_rows_plain, pbuf, rows32, n32),
            bound=(store_bytes(n32), 0, FP32_FLOPS),
        ))
    return cases


def _kv(dev, g, hd):
    """Random int8 K/V rows with their fp32 scales: kv(*lead) -> (k8, ks, v8, vs)."""
    i8 = lambda *shape: torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
    sc = lambda *shape: torch.exp(torch.randn(shape, generator=g, device=dev) * 0.4 - 4.0)
    return lambda *lead: (i8(*lead, hd), sc(*lead), i8(*lead, hd), sc(*lead))


def _kv_form_cases(dev, g, rnd, nl, hkv, gq, hd):
    """The int8 KV forms beside the serve path's, over caches of `nl` layers
    that the calls walk in turn (each call reads its layer from HBM): at the
    serve pool's shape (KV_SLOTS slots, capacity KV_CAP) H4 without its fresh
    column on a one-layer view (K13) and with layer= (K14), H4 in QI8 mode
    (K6's int8 x int8 body), H5 with the causal limit instead of fresh columns
    (K16, the suffix pass's kq = 32), H6 into one layer, 1 and 32 rows (K17,
    K18); and H4 with n_valid (K15) at B = 96, C = 1280 with 640..1280 live
    rows per slot, whose bound counts the live rows only."""
    from padt_tpu_torch.ops import cuda_kv as K

    kv, none4 = _kv(dev, g, hd), (None,) * 4
    b, cap = KV_SLOTS, KV_CAP
    cache = kv(nl, b, hkv, cap)
    cols = torch.arange(cap, device=dev)[None, :]
    lens = torch.randint(PROMPT_LEN - 100, cap - SUFFIX_K, (b,), generator=g, device=dev)
    valid = (cols < lens[:, None]) & (cols >= 40)
    wp = lens.int().contiguous()
    valid_sfx = valid | ((cols >= lens[:, None]) & (cols < lens[:, None] + SUFFIX_K))  # the suffix rows are stored
    fresh1 = kv(b, hkv, 1)
    qd, qv = rnd(b, hkv, gq, hd), rnd(b, hkv, gq * SUFFIX_K, hd)
    one, n32 = torch.ones(b, dtype=torch.int32, device=dev), torch.full((b,), SUFFIX_K, dtype=torch.int32, device=dev)
    row1 = [t[None] for t in kv(b, hkv, 1)]  # one layer's rows, (1, B, Hkv, n, ...)
    row32 = [t[None] for t in kv(b, hkv, SUFFIX_K)]
    kbuf, pbuf = [t.clone() for t in cache], [t.clone() for t in cache]
    layer_bytes = nbytes(*cache) // nl

    def walk(fn, *head, tail=(), view=False, **kw):
        """fn over layers 0, 1, ...: with layer= (fn(*head, *cache, ..., layer)),
        or on a one-layer view of layer i (view=True)."""
        nxt = itertools.cycle(range(nl)).__next__

        def call():
            i = nxt()
            return fn(*head, *(t[i : i + 1] for t in cache), *tail, 0, **kw) if view else fn(*head, *cache, *tail, i, **kw)

        return call

    def store(fn, buf, rows, n):
        nxt = itertools.cycle(range(nl)).__next__

        def call():
            i = nxt()
            fn(*(t[i : i + 1] for t in buf), *rows, wp, n)
            return buf

        return call

    attn_ops = lambda q_rows, cols_: 4 * hd * hkv * q_rows * cols_  # QK and PV: int8 is exact in bf16, so bf16 tensor cores
    live, live_sfx = int(valid.sum()), int(valid_sfx.sum())
    qi8_ops = (2 * hd * hkv * gq * live, 2 * hd * hkv * gq * (live + 2 * b))  # int8 x int8 scores; fresh scores + PV in bf16
    dec = f"decode {b} slots x {hkv} kv heads x {gq} q x{hd}, int8 cache {nl}x{cap} (layers in turn)"
    cases = [
        dict(name="int8_decode_attn", path="forms", source="int8_kv.cu", replaces="padt_tpu/ops/kv_cache.py:87", tol=TOL,
             relative=True, norm=True, shape=f"K13 {dec}, unstacked (a one-layer view), no fresh column",
             kern=walk(K.int8_decode_attn, qd, tail=(*none4, valid), view=True),
             plain=walk(K.int8_decode_attn_plain, qd, tail=(*none4, valid), view=True),
             bound=(layer_bytes + nbytes(qd, valid) + nbytes(qd), attn_ops(gq, live), BF16_TENSOR_FLOPS)),
        dict(name="int8_decode_attn", path="forms", source="int8_kv.cu", replaces="padt_tpu/ops/kv_cache.py:135", tol=TOL,
             relative=True, norm=True, shape=f"K14 {dec}, layer=, no fresh column",
             kern=walk(K.int8_decode_attn, qd, tail=(*none4, valid)), plain=walk(K.int8_decode_attn_plain, qd, tail=(*none4, valid)),
             bound=(layer_bytes + nbytes(qd, valid) + nbytes(qd), attn_ops(gq, live), BF16_TENSOR_FLOPS)),
        dict(name="int8_decode_attn_qi8", path="3b_qi8", source="int8_kv.cu", replaces="padt_tpu/ops/kv_cache.py:173", tol=TOL,
             norm=True, shape=f"K6 quantize_q (int8 x int8 scores) {dec}, 1 fresh column",
             kern=walk(K.int8_decode_attn, qd, tail=(*fresh1, valid), quantize_q=True),
             plain=walk(K.int8_decode_attn_plain, qd, tail=(*fresh1, valid), quantize_q=True), ulp=True,
             apart=walk(K.int8_decode_attn_plain, qd, tail=(*fresh1, valid)), apart_name="bf16-score twin",
             bound=(layer_bytes + nbytes(qd, *fresh1, valid) + nbytes(qd), qi8_ops, (INT8_TENSOR_OPS, BF16_TENSOR_FLOPS))),
        dict(name="int8_verify_attn", path="forms", source="int8_kv.cu", replaces="padt_tpu/ops/kv_cache.py:1340", tol=TOL,
             relative=True, norm=True, shape=f"K16 suffix pass {b} slots x {hkv} kv heads x ({gq}x{SUFFIX_K}) q x{hd}, int8 cache {nl}x{cap} holding the "
                   f"{SUFFIX_K} new rows (layers in turn), causal limit from write_pos",
             kern=walk(K.int8_verify_attn, qv, tail=(*none4, valid_sfx), kq=SUFFIX_K, write_pos=wp),
             plain=walk(K.int8_verify_attn_plain, qv, tail=(*none4, valid_sfx), kq=SUFFIX_K, write_pos=wp),
             bound=(layer_bytes + nbytes(qv, valid_sfx) + nbytes(qv), attn_ops(gq * SUFFIX_K, live_sfx), BF16_TENSOR_FLOPS)),
        dict(name="store_kv_rows", path="forms", source="int8_kv.cu", replaces="padt_tpu/ops/kv_cache.py:683", tol=0.0,
             shape=f"K17 one row per slot into one layer (layers in turn) x {b} slots x {hkv} kv heads, capacity {cap}",
             kern=store(K.store_kv_rows, kbuf, row1, one), plain=store(K.store_kv_rows_plain, pbuf, row1, one),
             bound=(2 * b * hkv * (2 * hd + 8), 0, FP32_FLOPS)),
        dict(name="store_kv_rows", path="forms", source="int8_kv.cu", replaces="padt_tpu/ops/kv_cache.py:1220", tol=0.0,
             shape=f"K18 {SUFFIX_K} rows per slot into one layer (layers in turn) x {b} slots x {hkv} kv heads, capacity {cap}",
             kern=store(K.store_kv_rows, kbuf, row32, n32), plain=store(K.store_kv_rows_plain, pbuf, row32, n32),
             bound=(2 * SUFFIX_K * b * hkv * (2 * hd + 8), 0, FP32_FLOPS)),
    ]
    # K15 at the decode micro-benchmark's shape: 96 slots, capacity 1280, 640..1280 live rows
    b96, c96 = 96, 1280
    big = kv(nl, b96, hkv, c96)
    nv = torch.randint(640, c96 + 1, (b96,), generator=g, device=dev, dtype=torch.int32)
    valid96 = torch.arange(c96, device=dev)[None, :] < nv[:, None]
    q96 = rnd(b96, hkv, gq, hd)

    def tiled(fn):
        nxt = itertools.cycle(range(nl)).__next__

        def call():
            i = nxt()
            return fn(q96, *(t[i : i + 1] for t in big), *none4, valid96, 0, n_valid=nv)

        return call

    n_live = int(nv.sum())
    # the twin rounds as K15 does (p against the running max, per 256-row tile) and the kernel as the one-pass
    # softmax (p / denom): tolerance relative to the output's largest magnitude, as JAX's own 2e-2 rtol
    cases.append(dict(
        name="int8_decode_attn", path="forms", source="int8_kv.cu", replaces="padt_tpu/ops/kv_cache.py:545", tol=TOL, relative=True,
        norm=True, shape=f"K15 decode {b96} slots x {hkv} kv heads x {gq} q x{hd}, unstacked int8 cache {nl}x{c96} (layers in turn), "
              f"n_valid 640..{c96} ({n_live / b96:.0f} live rows per slot on average)",
        kern=tiled(K.int8_decode_attn), plain=tiled(K.int8_decode_attn_plain),
        bound=(n_live * (hkv * (2 * hd + 2 * 4) + 1) + 2 * nbytes(q96) + nbytes(nv), attn_ops(gq, n_live), BF16_TENSOR_FLOPS)))
    return cases


def rope_key(rows, hq, hk):
    """The launch key of H1 at one shape (cuda_attention.rope_launches_by_shape)."""
    return f"rope_qk rows={rows} heads={hq}+{hk}"


def _with_rope_shapes(counts):
    """The launch counts with H1's split by shape, read from the wrapper's own
    split."""
    from padt_tpu_torch.ops import cuda_attention as C

    for (rows, hq, hk), n in C.rope_launches_by_shape.items():
        counts[rope_key(rows, hq, hk)] = n
    return counts


def _rope_case(q, k, cos, sin, hq, hk, path, replaces, shape, sign=1.0):
    """H1 at one shape, held to 2e-2 and to one bf16 ulp of its largest
    output; its launches are those at its own shape (rows, q heads, k
    heads) on `path`."""
    from padt_tpu_torch.ops import cuda_attention as C

    rows = q.shape[0] * q.shape[1]
    return dict(name="rope_qk", path=path, source="rope_qk.cu", replaces=replaces, tol=TOL, ulp=True, shape=shape,
                launch_key=rope_key(rows, hq, hk),
                kern=lambda: C.rope_qk(q, k, cos, sin, hq, hk, sin_sign=sign),
                plain=lambda: C.rope_qk_plain(q, k, cos, sin, hq, hk, sin_sign=sign),
                bound=(2 * nbytes(q, k) + nbytes(cos, sin), 3 * (q.numel() + k.numel()), FP32_FLOPS))


def _text_rope_cases(dev, rnd, b, l, h, hkv, hd, fused, path, shape, pos0=0):
    """H1 on the text q/k of `b` rows of `l` tokens (positions from pos0),
    q/k as column views of a fused (packed) qkv buffer or tensors of their own."""
    from padt_tpu_torch.ops.rope import mrope_cos_sin

    pos = (torch.arange(l, device=dev) + pos0)[None].expand(b, l)
    tcos, tsin = mrope_cos_sin(pos[None].expand(3, b, l), hd, (16, 24, 24))
    if fused:
        qkv = rnd(b, l, (h + 2 * hkv) * hd)
        q, k = qkv[..., : h * hd], qkv[..., h * hd : (h + hkv) * hd]
    else:
        q, k = rnd(b, l, h * hd), rnd(b, l, hkv * hd)
    return _rope_case(q, k, tcos, tsin, h, hkv, path, "padt_tpu/ops/pallas_attention.py:574", shape)


def _text_cases(dev, rnd, b, h, hkv, hd, path, tag, rope_yardstick=False):
    """H1 on the text q/k and H2 on a causal GQA prefill of a `b`-row bucket
    of 640 tokens, row 0 left-padded by 100 tokens. `rope_yardstick` makes
    the H1 line a yardstick (no path runs H1 at this shape)."""
    from padt_tpu_torch.ops import cuda_attention as C
    from padt_tpu_torch.ops.rope import mrope_cos_sin

    l = PROMPT_LEN
    pos = torch.arange(l, device=dev)[None].expand(b, l) - torch.tensor([[100]] + [[0]] * (b - 1), device=dev)
    tcos, tsin = mrope_cos_sin(pos.clamp(min=0)[None].expand(3, b, l), hd, (16, 24, 24))
    tq, tk, tv = rnd(b, l, h * hd), rnd(b, l, hkv, hd), rnd(b, l, hkv, hd)
    tseg = ((pos >= 0).int() - 1).contiguous()  # row 0 left-padded by 100 tokens: seg -1
    q4 = tq.unflatten(-1, (h, hd))
    pairs, mask = _visible_pairs(tseg, tseg, True)
    return [
        _rope_case(tq, tk.flatten(2), tcos, tsin, h, hkv, None if rope_yardstick else path,
                   "padt_tpu/ops/pallas_attention.py:574", f"{tag}text {b}x{l}x({h}+{hkv})x{hd}"),
        dict(name="segment_flash_fwd", path=path, source="segment_flash.cu", replaces="padt_tpu/ops/pallas_attention.py:65", tol=TOL,
             shape=f"{tag}text prefill causal GQA {b}x{l}, {h}/{hkv} heads x{hd}, left pad 100",
             kern=lambda: C.segment_flash_fwd(q4, tk, tv, tseg, tseg, True, hd**-0.5),
             plain=lambda: C.segment_flash_plain(q4, tk, tv, tseg, tseg, True, hd**-0.5),
             library=_sdpa(q4, tk, tv, mask[:, None], hd**-0.5, gqa=True),
             bound=(2 * nbytes(tq) + nbytes(tk, tv, tseg), 4 * hd * h * pairs, BF16_TENSOR_FLOPS)),
    ]


def _train_cases(dev, rnd, b, l, h, hkv, hd, tag, names=("segment_flash_fwd", "rope_qk", "flash_bwd_dq", "flash_bwd_dkv"),
                 path="train"):
    """The train step's text-layer kernels on a causal GQA bucket of `b`
    rows of `l` tokens, row 0 left-padded by 100 tokens: H2 with its LSE,
    H1 with the sin negated (the rope's VJP), H8 and H9 from that LSE and
    delta. The yardstick of H8 and H9 is the backward of
    scaled_dot_product_attention (the same boolean mask, enable_gqa), timed
    as torch.autograd.grad on its output without the forward. `path` None
    makes the lines yardsticks (a shape no path trains)."""
    import torch.nn.functional as F

    from padt_tpu_torch.ops import cuda_attention as C
    from padt_tpu_torch.ops import cuda_flash_bwd as FB
    from padt_tpu_torch.ops.rope import mrope_cos_sin

    pos = torch.arange(l, device=dev)[None].expand(b, l) - torch.tensor([[100]] + [[0]] * (b - 1), device=dev)
    tcos, tsin = mrope_cos_sin(pos.clamp(min=0)[None].expand(3, b, l), hd, (16, 24, 24))
    q, g = rnd(b, l, h, hd), rnd(b, l, h, hd)
    k, v = rnd(b, l, hkv, hd), rnd(b, l, hkv, hd)
    gq, gk = rnd(b, l, h * hd), rnd(b, l, hkv * hd)
    seg = ((pos >= 0).int() - 1).contiguous()
    pairs, mask = _visible_pairs(seg, seg, True)
    scale = hd**-0.5
    out, lse = C.segment_flash_fwd(q, k, v, seg, seg, True, scale, return_lse=True)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, g, seg, seg, lse, delta, True, scale)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    sd_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None], scale=scale, enable_gqa=True)
    sdpa_bwd = lambda: torch.autograd.grad(sd_out, (qt, kt, vt), g.transpose(1, 2), retain_graph=True)
    reads = nbytes(q, k, v, g, lse, delta, seg)
    shape = f"{tag}train step causal GQA {b}x{l}, {h}/{hkv} heads x{hd}, left pad 100"
    # a row with no visible key carries LSE 1e30: compared as 0 on both sides
    finite_lse = lambda r: (r[0], torch.where(r[1] >= 1e29, torch.zeros_like(r[1]), r[1]))
    cases = {
        "segment_flash_fwd": dict(
            name="segment_flash_fwd", path=path, source="segment_flash.cu", replaces="padt_tpu/ops/pallas_attention.py:65",
            tol=TOL, shape=shape + ", with its LSE", view=finite_lse,
            kern=lambda: C.segment_flash_fwd(q, k, v, seg, seg, True, scale, return_lse=True),
            plain=lambda: C.segment_flash_plain(q, k, v, seg, seg, True, scale, return_lse=True),
            library=_sdpa(q, k, v, mask[:, None], scale, gqa=True),
            bound=(2 * nbytes(q) + nbytes(k, v, seg, lse), 4 * hd * h * pairs, BF16_TENSOR_FLOPS)),
        "rope_qk": _rope_case(gq, gk, tcos, tsin, h, hkv, path, "padt_tpu/ops/pallas_attention.py:574",
                              f"{tag}text {b}x{l}x({h}+{hkv})x{hd}, sin negated: the rope's VJP", sign=-1.0),
        "flash_bwd_dq": dict(
            name="flash_bwd_dq", path=path, source="flash_bwd.cu", replaces="padt_tpu/ops/pallas_attention.py:348",
            tol=TOL, relative=True, norm=True, shape=shape + ", dq",
            kern=lambda: FB.flash_bwd_dq(*args), plain=lambda: FB.flash_bwd_dq_plain(*args), library=sdpa_bwd,
            bound=(reads + nbytes(q), 6 * hd * h * pairs, BF16_TENSOR_FLOPS)),
        "flash_bwd_dkv": dict(
            name="flash_bwd_dkv", path=path, source="flash_bwd.cu", replaces="padt_tpu/ops/pallas_attention.py:392",
            tol=TOL, relative=True, norm=True, shape=shape + ", dk and dv",
            kern=lambda: FB.flash_bwd_dkv(*args), plain=lambda: FB.flash_bwd_dkv_plain(*args), library=sdpa_bwd,
            bound=(reads + nbytes(k, v), 8 * hd * h * pairs, BF16_TENSOR_FLOPS)),
    }
    return [cases[n] for n in names]


def _vision_bwd_cases(q, k, v, g, seg, what, path=None):
    """H8 and H9 at a vision tower's shape (B x 2304, 16 heads of 80,
    non-causal) on one of its layouts, q/k/v views of the fused qkv buffer,
    from H2's LSE: the trained tower's backward at 8 x 2304 (path
    "train_tower"), at 2 x 2304, where they were first timed, as
    yardsticks (path None)."""
    import torch.nn.functional as F

    from padt_tpu_torch.ops import cuda_attention as C
    from padt_tpu_torch.ops import cuda_flash_bwd as FB

    b, s, h, hd = q.shape
    scale = hd**-0.5
    pairs, mask = _visible_pairs(seg, seg, False)
    out, lse = C.segment_flash_fwd(q, k, v, seg, seg, False, scale, return_lse=True)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, g, seg, seg, lse, delta, False, scale)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    sd_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None], scale=scale)
    sdpa_bwd = lambda: torch.autograd.grad(sd_out, (qt, kt, vt), g.transpose(1, 2), retain_graph=True)
    reads = nbytes(q, k, v, g, lse, delta, seg)
    shape = f"vision backward {b}x{s}x{h}x{hd} on {what}, q/k/v views of the fused qkv"
    return [
        dict(name="flash_bwd_dq", path=path, source="flash_bwd.cu", replaces="padt_tpu/ops/pallas_attention.py:348",
             tol=TOL, relative=True, norm=True, shape=shape + ", dq",
             kern=lambda: FB.flash_bwd_dq(*args), plain=lambda: FB.flash_bwd_dq_plain(*args), library=sdpa_bwd,
             bound=(reads + nbytes(q), 6 * hd * h * pairs, BF16_TENSOR_FLOPS)),
        dict(name="flash_bwd_dkv", path=path, source="flash_bwd.cu", replaces="padt_tpu/ops/pallas_attention.py:392",
             tol=TOL, relative=True, norm=True, shape=shape + ", dk and dv",
             kern=lambda: FB.flash_bwd_dkv(*args), plain=lambda: FB.flash_bwd_dkv_plain(*args), library=sdpa_bwd,
             bound=(reads + nbytes(k, v), 8 * hd * h * pairs, BF16_TENSOR_FLOPS)),
    ]


def _vision_lse_case(q, k, v, seg, what):
    """H2 with its LSE on a layout of the trained tower (8 x 2304, 16 heads
    of 80, non-causal; the rotated q/k, v a view of the fused qkv): the
    output held to 2e-2 of its largest value, the LSE to 2e-2 absolute, on
    the rows that see a key (a pad row gives 0 and LSE 1e30 in both)."""
    from padt_tpu_torch.ops import cuda_attention as C

    b, s, h, hd = q.shape
    pairs, mask = _visible_pairs(seg, seg, False)
    scale = hd**-0.5
    live = (seg >= 0)[:, None, :]  # (B, 1, S)
    view = lambda r: (r[0], torch.where(live, r[1], torch.zeros_like(r[1])))
    return dict(name="segment_flash_fwd", path="train_tower", source="segment_flash.cu",
                replaces="padt_tpu/ops/pallas_attention.py:769", tol=TOL, relative=(True, False), view=view,
                shape=f"vision layer {b}x{s}x{h}x{hd} on {what}, with its LSE (the trained tower's forward)",
                kern=lambda: C.segment_flash_fwd(q, k, v, seg, seg, False, scale, return_lse=True),
                plain=lambda: C.segment_flash_plain(q, k, v, seg, seg, False, scale, return_lse=True),
                library=_sdpa(q, k, v, mask[:, None], scale),
                bound=(2 * nbytes(q) + nbytes(k, v, seg) + b * h * s * 4, 4 * hd * h * pairs, BF16_TENSOR_FLOPS))


def report_bwd_pairs(entries, card):
    """[bwd]: per shape, H8 + H9 (the whole backward, in two launches)
    against SDPA's whole backward, from the kernel lines' times."""
    by_shape = {}
    for e in entries:
        if e["name"] in ("flash_bwd_dq", "flash_bwd_dkv"):
            by_shape.setdefault(e["shape"].rsplit(", d", 1)[0], {})[e["name"]] = e
    for shape, pair in by_shape.items():
        dq, dkv = pair["flash_bwd_dq"], pair["flash_bwd_dkv"]
        both, lib = dq["ms"] + dkv["ms"], dkv["library_ms"]
        log(f"[bwd] {shape}: H8 {dq['ms']:.4f} + H9 {dkv['ms']:.4f} = {both:.4f} ms, SDPA backward {lib:.4f} ms "
            f"({both / lib:.3f} of it), bound {dq['bound_ms'] + dkv['bound_ms']:.4f} ms ({card})")


def _sass(fn, so):
    """The SASS of kernel `fn` (a mangled name) in library `so`."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return subprocess.run([tool, "-sass", "-fun", fn, str(so)], capture_output=True, text=True, timeout=120, check=True).stdout


def report_ptxas():
    """[ptxas]: registers and spill bytes of every H8 / H9 instance, every
    H7 / H10 GEMM instance (gemm_sm90.cuh), every H4 / H5 instance, every
    H1 / H3 instance and H6, from the build's ptxas report; any spill fails the
    run, and so does an H4 / H5 / H3 instance whose SASS has no tensor-core
    product (H4's HMMA, and IMMA for its int8 x int8 scores; H5's and H3's
    HGMMA)."""
    import re

    from padt_tpu_torch.ops import _build

    so = _build.build()
    seen = {"bwd": 0, "gemm": 0, "kv": 0, "rope": 0, "win": 0, "store": 0}
    for fn, (regs, st, ld) in sorted(_build.resource_usage().items()):
        mma = ()
        if m := re.search(r"(dq_kernel|dkv_kernel)ILi(\d+)ELb([01])E", fn):
            seen["bwd"] += 1
            kern = {"dq_kernel": "H8 flash_bwd_dq", "dkv_kernel": "H9 flash_bwd_dkv"}[m.group(1)]
            what = f"{kern} hd {m.group(2)} causal {m.group(3)}"
        elif m := re.search(r"gemm_kernelILb([01])ELb([01])ELi(\d+)EE", fn):
            seen["gemm"] += 1
            kern = "H7 int8_matmul" if m.group(1) == "1" else "H10 stream_matmul"
            what = f"{kern} {'swap-AB' if m.group(2) == '1' else 'prefill'} n {m.group(3)}"
        elif m := re.search(r"decode_kernelILi(\d+)ELb([01])E", fn):
            seen["kv"] += 1
            qi8 = m.group(2) == "1"
            what, mma = f"H4 int8_decode_attn hd {m.group(1)}{' quantize_q' if qi8 else ''}", ("HMMA", "IMMA") if qi8 else ("HMMA",)
        elif m := re.search(r"verify_kernelILi(\d+)ELi(\d+)EE", fn):
            seen["kv"] += 1
            what, mma = f"H5 int8_verify_attn hd {m.group(1)}, {m.group(2)} row tile(s)", ("HGMMA",)
        elif m := re.search(r"rope_qk_kernelILi(\d+)EE", fn):
            seen["rope"] += 1
            what = f"H1 rope_qk, {m.group(1)} head(s) a thread"
        elif m := re.search(r"window_slot_kernelILi(\d+)EE", fn):
            seen["win"] += 1
            what, mma = f"H3 window_slot_attn hd {m.group(1)}", ("HGMMA",)
        elif m := re.search(r"store_rows_flat_kernelILi(\d+)EE", fn):
            seen["store"] += 1
            what = f"H6 store_kv_rows, {m.group(1)} row(s) a thread"
        else:
            continue
        counts = ""
        if mma:
            sass = _sass(fn, so)
            found = {op: sass.count(op) for op in mma}
            counts = ", " + ", ".join(f"{n} {op}" for op, n in found.items()) + " in its SASS"
            if not all(found.values()):
                raise AssertionError(f"{what}: no tensor-core product in its SASS ({found})")
        log(f"[ptxas] {what}: {regs} registers at launch, {st} bytes spill stores, {ld} bytes spill loads{counts}")
        if st or ld:
            raise AssertionError(f"{what} spills ({st} / {ld} bytes)")
    # H8 / H9: 5 head dims x causal or not; H7 / H10: 6 swap-AB n and one prefill tile each; H4: 5 head dims x
    # bf16 or int8 scores, H5: 4 head dims x one or two row tiles, and hd 256; H1: 1 or 2 heads a thread;
    # H3: 5 head dims; H6: 1 or 2 rows a thread
    want = {"bwd": 2 * 2 * 5, "gemm": 2 * (6 + 1), "kv": 5 * 2 + 4 * 2 + 1, "rope": 2, "win": 5, "store": 2}
    if seen != want:
        raise AssertionError(f"ptxas reported {seen} instances, expected {want}")


def phase_kernels(dev, card):
    """Each kernel vs its twin at main-path shapes (PaDT-3B's, and PaDT-7B's
    where its head counts differ); H7's lines come with the 7B weights in
    phase_7b. One entry per (kernel, shape)."""
    from padt_tpu_torch import padt_3b, padt_7b
    from padt_tpu_torch.models.vision_geom import vision_geometry
    from padt_tpu_torch.ops import _build
    from padt_tpu_torch.ops import cuda_attention as C
    from padt_tpu_torch.ops.rope import vision_rope_cos_sin

    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] {_build.library_path().relative_to(ROOT)} ready in {time.perf_counter() - t0:.1f} s")
    report_ptxas()

    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape: (torch.randn(shape, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    geo = vision_geometry([GRID] * 2, PATCHES)
    assert geo.pack_index is not None, "3B geometry should use the window-slot layout"
    T = lambda a: torch.as_tensor(a, device=dev)
    vcos, vsin = vision_rope_cos_sin(T(geo.hpos), T(geo.wpos), 80)
    seg_full, seg_win = T(geo.seg_full), T(geo.seg_win)
    b, s, h, hd = 2, PATCHES, 16, 80
    qkv = rnd(b, s, 3 * h * hd)
    vq, vk, vv = (qkv[..., i * h * hd : (i + 1) * h * hd] for i in range(3))
    vqr, vkr = C.rope_qk(vq, vk, vcos, vsin, h, h)
    u = lambda t: t.unflatten(-1, (h, hd))
    full_pairs, full_mask = _visible_pairs(seg_full, seg_full, False)
    seg_win_pairs, seg_win_mask = _visible_pairs(seg_win, seg_win, False)
    win = torch.arange(s, device=dev) // C.WINDOW
    win_mask = (win[:, None] == win[None, :])[None] & (seg_win[:, None, :] >= 0)
    win_pairs = int(win_mask.sum())
    vis_bytes = 4 * nbytes(vq) + nbytes(seg_full)

    c3, c7 = padt_3b().text, padt_7b().text

    def tower(n):  # (q, k, v views of a fused (n, 2304, 3 * 16 * 80) qkv, cos, sin, seg_win, seg_full) of n images
        g_n = vision_geometry([GRID] * n, PATCHES)
        c_n, s_n = vision_rope_cos_sin(T(g_n.hpos), T(g_n.wpos), 80)
        qkv_n = rnd(n, s, 3 * h * hd)
        return (*(qkv_n[..., i * h * hd : (i + 1) * h * hd] for i in range(3)), c_n, s_n, T(g_n.seg_win), T(g_n.seg_full))

    k1 = "padt_tpu/ops/pallas_attention.py:700"
    bq, bk, _, bcos, bsin, _, _ = tower(BATCH)  # run_batch's tower: BATCH images
    tq8, tk8, tv8, tcos8, tsin8, tseg8, tfull8 = tower(TRAIN_BATCH)  # the train step's tower
    tq8r, tk8r = C.rope_qk(tq8, tk8, tcos8, tsin8, h, h)
    tw_mask = (win[:, None] == win[None, :])[None] & (tseg8[:, None, :] >= 0)
    tw_pairs = int(tw_mask.sum())
    cases = [
        _rope_case(bq, bk, bcos, bsin, h, h, "3b_batch", k1, f"vision {BATCH}x2304x(16+16)x80 (run_batch's tower), q/k views of the fused qkv"),
        # the 2x2304 shape the first H1 body was timed at (no path runs it): a yardstick
        _rope_case(vq, vk, vcos, vsin, h, h, None, k1, "vision 2x2304x(16+16)x80, q/k views of the fused qkv"),
        _rope_case(tq8, tk8, tcos8, tsin8, h, h, "train", k1,
                   f"vision {TRAIN_BATCH}x2304x(16+16)x80 (the train step's frozen tower), q/k views of the fused qkv"),
        # the text layers: run_batch's prefill (the first body's 2x640 shape a yardstick), its decode steps, the
        # serve pool's decode steps over the packed weights' fused qkv, PaDT-7B's
        _text_rope_cases(dev, rnd, BATCH, PROMPT_LEN, c3.num_attention_heads, c3.num_key_value_heads, c3.head_dim,
                         False, "3b_batch", f"text {BATCH}x{PROMPT_LEN}x(16+2)x128 (run_batch's prefill)"),
        _text_rope_cases(dev, rnd, BATCH, 1, c3.num_attention_heads, c3.num_key_value_heads, c3.head_dim,
                         False, "3b_batch", f"decode {BATCH}x1x(16+2)x128 (run_batch's decode steps)", pos0=PROMPT_LEN),
        _text_rope_cases(dev, rnd, SERVE_SLOTS, 1, c3.num_attention_heads, c3.num_key_value_heads, c3.head_dim,
                         True, "3b_serve", f"decode {SERVE_SLOTS}x1x(16+2)x128 (the serve pool's decode steps), "
                         "q/k views of the fused qkv", pos0=PROMPT_LEN),
        _text_rope_cases(dev, rnd, SERVE_SLOTS, 1, c7.num_attention_heads, c7.num_key_value_heads, c7.head_dim,
                         True, "7b", f"7B decode {SERVE_SLOTS}x1x(28+4)x128 (run_stream's decode steps), "
                         "q/k views of the fused qkv", pos0=PROMPT_LEN),
        *_text_cases(dev, rnd, 2, c3.num_attention_heads, c3.num_key_value_heads, c3.head_dim, "3b_batch", "",
                     rope_yardstick=True),
        # H2's vision lines: outputs of ~1e-2 (a row averages ~2116 keys, or ~64 in a window), so the
        # tolerance is TOL times the largest reference output, a few bf16 ulp: one dropped key tile fails it
        dict(name="segment_flash_fwd", path="3b_batch", source="segment_flash.cu", replaces="padt_tpu/ops/pallas_attention.py:769",
             tol=TOL, relative=True, shape="vision full layer 2x2304x16x80 on seg_full",
             kern=lambda: C.segment_flash_fwd(u(vqr), u(vkr), u(vv), seg_full, seg_full, False, hd**-0.5),
             plain=lambda: C.segment_flash_plain(u(vqr), u(vkr), u(vv), seg_full, seg_full, False, hd**-0.5),
             library=_sdpa(u(vqr), u(vkr), u(vv), full_mask[:, None], hd**-0.5),
             bound=(vis_bytes, 4 * hd * h * full_pairs, BF16_TENSOR_FLOPS)),
        # H3: outputs of ~1e-1 (a row averages ~60 keys): held to TOL of the largest and a 1e-2 norm gap
        dict(name="window_slot_attn", path="3b_batch", source="window_attn.cu", replaces="padt_tpu/ops/pallas_attention.py:860",
             tol=TOL, relative=True, norm=True, shape="vision windowed layer 2x2304x16x80 on seg_win, v a view of the fused qkv",
             kern=lambda: C.window_slot_attn(u(vqr), u(vkr), u(vv), seg_win, hd**-0.5),
             plain=lambda: C.window_slot_plain(u(vqr), u(vkr), u(vv), seg_win, hd**-0.5),
             library=_sdpa(u(vqr), u(vkr), u(vv), win_mask[:, None], hd**-0.5),
             bound=(vis_bytes, 4 * hd * h * win_pairs, BF16_TENSOR_FLOPS)),
        dict(name="window_slot_attn", path="train", source="window_attn.cu", replaces="padt_tpu/ops/pallas_attention.py:860",
             tol=TOL, relative=True, norm=True,
             shape=f"vision windowed layer {TRAIN_BATCH}x2304x16x80 on seg_win (the train step's frozen tower)",
             kern=lambda: C.window_slot_attn(u(tq8r), u(tk8r), u(tv8), tseg8, hd**-0.5),
             plain=lambda: C.window_slot_plain(u(tq8r), u(tk8r), u(tv8), tseg8, hd**-0.5),
             library=_sdpa(u(tq8r), u(tk8r), u(tv8), tw_mask[:, None], hd**-0.5),
             bound=(4 * nbytes(tq8) + nbytes(tseg8), 4 * hd * h * tw_pairs, BF16_TENSOR_FLOPS)),
        # H2 on the window layout at 2 x 2304, the segment-tile skip's yardstick (it visits 1 of 18 key
        # tiles per query tile); the trained tower's 8 x 2304 line is below
        dict(name="segment_flash_fwd", path=None, source="segment_flash.cu", replaces="padt_tpu/ops/pallas_attention.py:769",
             tol=TOL, relative=True, shape="vision windowed layer 2x2304x16x80 on seg_win, segment-tile skip",
             kern=lambda: C.segment_flash_fwd(u(vqr), u(vkr), u(vv), seg_win, seg_win, False, hd**-0.5),
             plain=lambda: C.segment_flash_plain(u(vqr), u(vkr), u(vv), seg_win, seg_win, False, hd**-0.5),
             library=_sdpa(u(vqr), u(vkr), u(vv), seg_win_mask[:, None], hd**-0.5),
             bound=(vis_bytes, 4 * hd * h * seg_win_pairs, BF16_TENSOR_FLOPS)),
        *_int8_attn_cases(dev, g, rnd, c3.num_hidden_layers, KV_SLOTS, c3.num_key_value_heads,
                          c3.num_attention_heads // c3.num_key_value_heads, c3.head_dim, KV_CAP, "3b_serve", "", True),
        # the older int8 KV forms (K13-K18) and the QI8 score mode at the serve pool's shape, K15 at B = 96, C = 1280
        *_kv_form_cases(dev, g, rnd, c3.num_hidden_layers, c3.num_key_value_heads,
                        c3.num_attention_heads // c3.num_key_value_heads, c3.head_dim),
        # PaDT-7B: 28 q / 4 kv heads (G = 7), a 4-row prefill bucket, an 8-slot pool of 28 layers
        *_text_cases(dev, rnd, BATCH, c7.num_attention_heads, c7.num_key_value_heads, c7.head_dim, "7b", "7B "),
        *_int8_attn_cases(dev, g, rnd, c7.num_hidden_layers, SERVE_SLOTS, c7.num_key_value_heads,
                          c7.num_attention_heads // c7.num_key_value_heads, c7.head_dim, KV_CAP, "7b", "7B ", False),
        # the train step's text layers: 8 rows of 640 + 64 tokens; and H8 / H9 at 7B's heads (7:1), yardsticks:
        # no path trains PaDT-7B
        *_train_cases(dev, rnd, TRAIN_BATCH, TRAIN_LEN, c3.num_attention_heads, c3.num_key_value_heads, c3.head_dim, ""),
        *_train_cases(dev, rnd, BATCH, TRAIN_LEN, c7.num_attention_heads, c7.num_key_value_heads, c7.head_dim, "7B ",
                      names=("flash_bwd_dq", "flash_bwd_dkv"), path=None),
        # the trained tower ([train-tower], 8 x 2304): H2 with its LSE and H8 / H9 over seg_full and over the
        # window-slot ids seg_win (the segment-tile skip); the 2 x 2304 H8 / H9 lines stay as yardsticks
        _vision_lse_case(u(tq8r), u(tk8r), u(tv8), tfull8, "seg_full"),
        _vision_lse_case(u(tq8r), u(tk8r), u(tv8), tseg8, "seg_win, segment-tile skip"),
        *_vision_bwd_cases(u(tq8), u(tk8), u(tv8), rnd(TRAIN_BATCH, s, h, hd), tfull8, "seg_full", "train_tower"),
        *_vision_bwd_cases(u(tq8), u(tk8), u(tv8), rnd(TRAIN_BATCH, s, h, hd), tseg8, "seg_win, segment-tile skip", "train_tower"),
        *_vision_bwd_cases(u(vq), u(vk), u(vv), rnd(b, s, h, hd), seg_full, "seg_full"),
        *_vision_bwd_cases(u(vq), u(vk), u(vv), rnd(b, s, h, hd), seg_win, "seg_win, segment-tile skip"),
    ]
    entries = measure(cases, card)
    report_bwd_pairs(entries, card)
    return entries


def phase_gqa(dev, card):
    """[gqa]: the measurement behind H2's one query head per work item
    (segment_flash.cu's note on GQA). Packing the G query heads of a kv head
    into one 128-row item (16 positions x G = 8 heads) streams as many K/V
    tiles per item over as many items as one head of 128 positions does, so
    it could save only distinct K/V bytes. H2 runs here at the main path's
    GQA shapes with their kv heads (G = 8 or 7; the G items of a kv head run
    side by side and share its tiles through L2) and with one kv head per
    query head (G = 1: G times the distinct K/V bytes, the same tiles per
    item), warm (the same inputs every call, K/V in L2 as after the rope
    kernel on the main path) and cold (a walk over copies of K/V three times
    the L2, so every call reads them from HBM). Logged, not held."""
    from padt_tpu_torch.ops import cuda_attention as C

    g = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *shape: (torch.randn(shape, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    hd = 128
    for what, b, l, h, hkv, lse in (("3B prefill", 2, PROMPT_LEN, 16, 2, False),  # the kernel lines' 3B prefill bucket
                                    ("3B train step, with its LSE", TRAIN_BATCH, TRAIN_LEN, 16, 2, True),
                                    ("7B prefill", BATCH, PROMPT_LEN, 28, 4, False)):
        pos = torch.arange(l, device=dev)[None].expand(b, l) - torch.tensor([[100]] + [[0]] * (b - 1), device=dev)
        seg = ((pos >= 0).int() - 1).contiguous()
        q = rnd(b, l, h, hd)
        ms = {}
        for n_kv in (hkv, h):
            copies = max(2, math.ceil(L2_WALK_BYTES / (4 * b * l * n_kv * hd)))
            kvs = [(rnd(b, l, n_kv, hd), rnd(b, l, n_kv, hd)) for _ in range(copies)]
            walk = itertools.cycle(kvs)
            call = lambda kv: C.segment_flash_fwd(q, *kv, seg, seg, True, hd**-0.5, return_lse=lse)
            ms[n_kv] = (cuda_ms(lambda: call(kvs[0])), cuda_ms(lambda: call(next(walk))))
            del kvs, walk
        (w8, c8), (w1, c1) = ms[hkv], ms[h]
        log(f"[gqa] H2 {what} causal {b}x{l}, {h} q heads x{hd}: G = {h // hkv} ({hkv} kv heads) warm {w8:.4f} ms, "
            f"cold {c8:.4f} ms; G = 1 ({h} kv heads, {h // hkv}x the K/V bytes) warm {w1:.4f} ms, cold {c1:.4f} ms "
            f"({card})")


def _u8_image(seed):
    import numpy as np

    from padt_tpu_torch.preprocess.vision_process import ProcessedImage

    t, gh, gw = GRID
    rows = np.random.RandomState(seed).randint(0, 256, (t * gh * gw, 3 * 14 * 14)).astype(np.uint8)
    return ProcessedImage(pixel_patches=None, grid_thw=GRID, pixel_patches_u8=rows)


def _finite(name, t, shape=None):
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise AssertionError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not torch.isfinite(t.float()).all():
        raise AssertionError(f"{name}: non-finite values")


PROMPTS = [
    'Please locate "the red car" in the image.',
    'Where is "the man on the left"?',
    'Find "the dog next to the bench".',
    'Locate "the second cup from the right".',
]


def _counters():
    """The kernel wrappers' modules, each with launch_counts and
    reset_launch_counts."""
    from padt_tpu_torch.ops import kernel_modules

    return kernel_modules()


def _processor(cfg):
    from padt_tpu_torch.utils.mock_tokenizer import make_full_tokenizer
    from padt_tpu_torch.vrt.processor import VisionTextProcessor

    proc = VisionTextProcessor(make_full_tokenizer(cfg), cfg)
    proc.prepare(cfg.text.vocab_size)
    return proc


def load_3b(dev):
    """PaDT-3B at full depth and width, random bf16 weights from a seed."""
    from padt_tpu_torch import padt_3b
    from padt_tpu_torch.models import padt as P

    cfg = padt_3b()
    assert cfg.max_image_patches == PATCHES
    t0 = time.perf_counter()
    params = P.init_padt_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, torch.bfloat16)
    model = P.PaDTModel(cfg, params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in model.state_dict().values())
    log(f"[slice] padt_3b random weights: {n_params / 1e9:.3f} B params bf16 in {time.perf_counter() - t0:.1f} s")
    return cfg, model, _processor(cfg)


def phase_run_batch(tag, dev, card, cfg, params, proc):
    """run_batch of BATCH REC queries with the launch counters reset just
    before and read just after; then generate, vision and prefill timed
    through the same public functions, and every output checked for shape
    and finiteness. Returns the launch counts and the results of run_batch."""
    from padt_tpu_torch.eval.harness import InferenceEngine
    from padt_tpu_torch.models import language
    from padt_tpu_torch.models import padt as P
    from padt_tpu_torch.ops import cuda_quant

    counters = _counters()

    prompts = PROMPTS[:BATCH]
    images = [_u8_image(i) for i in range(BATCH)]
    engine = InferenceEngine(params, cfg, proc, max_new_tokens=NEW_TOKENS)

    for c in counters:
        c.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.run_batch(prompts, images, prompt_bucket=PROMPT_LEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _with_rope_shapes({k: v for c in counters for k, v in c.launch_counts.items()})
    by_m = dict(sorted(cuda_quant.launches_by_m.items()))  # H7's launches by the rows of x
    log(f"[{tag}] run_batch of {BATCH} REC queries: {wall:.3f} s wall ({card}); launches {counts}"
        + (f"; H7 launches by M {by_m}" if by_m else ""))
    vc, tc = cfg.vision, cfg.text
    if len(results) != BATCH or not all(isinstance(r.completion, str) for r in results):
        raise AssertionError("run_batch returned malformed results")
    for r in results:
        for o in r.objects:
            if not (0.0 <= o.score <= 1.0):
                raise AssertionError(f"object score {o.score} out of [0, 1]")
    n_obj = sum(len(r.objects) for r in results)
    log(f"[{tag}] completions[0][:80] {results[0].completion[:80]!r}; objects parsed {n_obj}")

    # timed phases through the same public functions, and finiteness checks
    batch = proc.build_batch(prompts, images, patch_bucket=PATCHES, prompt_bucket=PROMPT_LEN)
    tb = engine._to_device(batch.data)
    deltas = torch.as_tensor(batch.rope_deltas, device=dev)
    with torch.inference_mode():
        def vision():
            return P.run_vision(params, cfg, tb)

        def vision_prefill():
            art = vision()
            emb = P.extended_embed(params, cfg, tb["input_ids"], art.proto, art.merged)
            return language.prefill(
                params["text"], tc, emb, tb["position_ids"], tb["attention_mask"].bool(),
                PROMPT_LEN + NEW_TOKENS,
            )

        t_vis = cuda_ms(vision, iters=3, warmup=1, hide_host=False)
        t_vp = cuda_ms(vision_prefill, iters=3, warmup=1, hide_host=False)
        gen = None

        def full():
            nonlocal gen
            gen = P.generate(params, cfg, tb, NEW_TOKENS, deltas, eos_token_id=-1)

        t_gen = cuda_ms(full, iters=2, warmup=1, hide_host=False)
        art = gen.artifacts
        m, d = cfg.max_merged_patches, tc.hidden_size
        _finite("merged", art.merged, (BATCH, m, d))
        _finite("proto", art.proto, (BATCH, m, d))
        _finite("high_res", art.high_res, (BATCH, PATCHES, vc.hidden_size))
        _finite("pe_cos", art.pe_cos, (BATCH, PATCHES, vc.head_dim))
        _finite("hidden", gen.hidden, (BATCH, NEW_TOKENS, d))
        if gen.tokens.shape != (BATCH, NEW_TOKENS) or int(gen.num_generated.min()) != NEW_TOKENS:
            raise AssertionError("generate did not emit every token")
        # the decoder at full width on 4 forced objects: hidden rows of the first 8 steps
        k = 8
        feats = torch.zeros((cfg.max_objects, cfg.max_vrt_per_object, d), dtype=gen.hidden.dtype, device=dev)
        feats[:BATCH, :k] = gen.hidden[:, :k]
        counts_o = torch.zeros((cfg.max_objects,), dtype=torch.int32, device=dev)
        counts_o[:BATCH] = k
        valid_o = counts_o > 0
        sample_o = torch.zeros((cfg.max_objects,), dtype=torch.int64, device=dev)
        sample_o[:BATCH] = torch.arange(BATCH, device=dev)
        t0 = time.perf_counter()
        dec = P.vl_decode(params, cfg, feats, counts_o, valid_o, sample_o, art)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        side = int(cfg.max_image_patches**0.5) + 1
        _finite("pred_boxes", dec.pred_boxes, (cfg.max_objects, 4))
        _finite("pred_score", dec.pred_score, (cfg.max_objects, 1))
        _finite("pred_mask", dec.pred_mask, (cfg.max_objects, 4 * side, 4 * side))
        if not bool(((dec.pred_boxes[:BATCH] >= 0) & (dec.pred_boxes[:BATCH] <= 1)).all()):
            raise AssertionError("boxes outside [0, 1]")
    prefill_ms = t_vp - t_vis
    decode_ms = t_gen - t_vp
    log(f"[{tag}] vision {t_vis:.2f} ms, prefill {prefill_ms:.2f} ms (vision+prefill {t_vp:.2f} ms), "
        f"generate {t_gen:.2f} ms, decode {decode_ms:.2f} ms = generate - (vision+prefill) for "
        f"{NEW_TOKENS} tokens x {BATCH} rows -> {BATCH * NEW_TOKENS / (decode_ms / 1e3):.1f} tok/s, "
        f"{decode_ms / (NEW_TOKENS - 1):.3f} ms per decode step; vl_decode {BATCH} objects (bucket {cfg.max_objects}) "
        f"{t_dec * 1e3:.2f} ms; batch {BATCH}, prompt {PROMPT_LEN}, bf16 KV ({card})")
    return counts, results


def phase_tiny_reference(dev):
    """Tiny model on the card (bf16, kernels) vs the plain float32 path on the
    CPU, same weights: the vision tower and bf16-KV prefill, then the int8
    serve path (int8 prefill into a 2-slot pool, one 32-wide suffix pass
    through H5 + H6, one decode step through H4 + H6); once with dense
    weights and once with int8 packed weights, quantized by the port on each
    device (every text-layer product through H7 on the card)."""
    import numpy as np

    from padt_tpu_torch import padt_tiny
    from padt_tpu_torch.models import language
    from padt_tpu_torch.models import padt as P
    from padt_tpu_torch.ops import cuda_attention as C
    from padt_tpu_torch.ops import cuda_kv as K
    from padt_tpu_torch.ops import cuda_quant as Q
    from padt_tpu_torch.ops import kv_cache as KC
    from padt_tpu_torch.preprocess.vision_process import ProcessedImage
    from padt_tpu_torch.serve import engine as S
    from padt_tpu_torch.utils.profiling import Recorder
    from padt_tpu_torch.utils.mock_tokenizer import make_tiny_tokenizer
    from padt_tpu_torch.vrt.processor import VisionTextProcessor

    cfg = padt_tiny()
    p32 = P.init_padt_params(cfg, torch.Generator().manual_seed(1), "cpu", torch.float32)
    to_dev = lambda t: {k: to_dev(v) for k, v in t.items()} if isinstance(t, dict) else t.to(dev, torch.bfloat16)
    p16 = to_dev(p32)
    proc = VisionTextProcessor(make_tiny_tokenizer(cfg), cfg, seq_bucket=32, patch_bucket=cfg.max_image_patches)
    proc.prepare(cfg.text.vocab_size)
    grids = [(1, 8, 12), (1, 16, 16)]
    imgs = [
        ProcessedImage(None, g, np.random.RandomState(i).randint(0, 256, (g[1] * g[2], 588)).astype(np.uint8))
        for i, g in enumerate(grids)
    ]
    batch = proc.build_batch(['find "x"', 'where is "y"'], imgs, patch_bucket=cfg.max_image_patches)
    sfx_ids = np.random.RandomState(7).randint(0, 100, (2, SUFFIX_K))
    sfx_len, step_ids, qi8_ids = [5, 3], [[11], [12]], [[13], [14]]

    def run(params, device):
        tb = {k: torch.as_tensor(v, device=device) for k, v in batch.data.items()}
        T = lambda a: torch.as_tensor(np.asarray(a), device=device)
        with torch.inference_mode():
            art = P.run_vision(params, cfg, tb)
            emb = P.extended_embed(params, cfg, tb["input_ids"], art.proto, art.merged)
            valid = tb["attention_mask"].bool()
            hid, _ = language.prefill(params["text"], cfg.text, emb, tb["position_ids"], valid, valid.shape[1])
            cap = -(-(valid.shape[1] + SUFFIX_K + 1) // 128) * 128
            st = S.init_state(cfg, 2, cap, 4, dtype=params["text"]["embed"].dtype, device=device)
            rec = Recorder()
            S.insert(st, S.prefill(params, cfg, tb, T(batch.rope_deltas), cap, rec=rec), T([0, 1]), T([4, 4]))
            S._suffix_prefill_step(params, cfg, st, T(sfx_ids), T(sfx_len), rec=rec)
            h_sfx = st.cur_hidden.float().cpu()
            h_step = S._decode_step_slots(params["text"], cfg.text, P.extended_embed(params, cfg, T(step_ids), st.proto), st, rec=rec)
            st.write_pos.add_(1)  # the next position, as decode_chunk moves it (in place)
            st.text_pos.add_(1)
            before = KC._QI8_DEFAULT
            KC._QI8_DEFAULT = True  # a second decode step with PADT_DECODE_QI8's int8 x int8 scores
            try:
                h_qi8 = S._decode_step_slots(
                    params["text"], cfg.text, P.extended_embed(params, cfg, T(qi8_ids), st.proto), st, rec=rec,
                )
            finally:
                KC._QI8_DEFAULT = before
            logits = P.extended_logits(params, cfg, h_qi8, st.proto, st.num_merged)[:, 0].float().cpu()
        return art.merged.float().cpu(), hid.float().cpu(), valid.cpu(), h_sfx, h_step.float().cpu(), h_qi8.float().cpu(), logits

    quantized = lambda p: P.pack_inference_params(P.quantize_params(p))
    for weights, ref_params, dev_params in (("bf16", p32, p16), ("int8", quantized(p32), quantized(p16))):
        if weights == "int8" and dev_params["text"]["layers"]["qkv_w_q"].device != dev:
            raise AssertionError("the int8 weights were not quantized on the card")
        n0 = (sum(C.launch_counts.values()), sum(K.launch_counts.values()), Q.launch_counts["int8_matmul"], K.launch_counts["int8_decode_attn_qi8"])
        m_ref, h_ref, valid, s_ref, d_ref, q_ref, lg_ref = run(ref_params, "cpu")
        m_dev, h_dev, _, s_dev, d_dev, q_dev, lg_dev = run(dev_params, dev)
        n1 = (sum(C.launch_counts.values()), sum(K.launch_counts.values()), Q.launch_counts["int8_matmul"], K.launch_counts["int8_decode_attn_qi8"])
        if n1[0] == n0[0] or n1[1] == n0[1] or (weights == "int8" and n1[2] == n0[2]) or n1[3] - n0[3] != cfg.text.num_hidden_layers:
            raise AssertionError(f"tiny reference run ({weights} weights) launched no kernel of a kind on the card")
        # greedy tokens of the QI8 step: equal wherever the CPU's top-2 logit margin exceeds twice the card's largest logit error
        top2 = lg_ref.topk(2, dim=-1).values
        lg_err = (lg_dev - lg_ref).abs().max().item()
        decided = (top2[:, 0] - top2[:, 1]) > 2 * lg_err
        tok_dev, tok_ref = lg_dev.argmax(-1), lg_ref.argmax(-1)
        log(f"[reference] tiny QI8 decode step, {weights} weights: greedy tokens card {tok_dev.tolist()} vs CPU {tok_ref.tolist()}, "
            f"{int(decided.sum())} of {len(decided)} rows decided beyond the logit error {lg_err:.3e}")
        if not bool((tok_dev == tok_ref)[decided].all()):
            raise AssertionError(f"tiny QI8 decode step ({weights} weights): a decided greedy token differs from the CPU's")
        for name, a, r, rows in (
            ("merged", m_dev, m_ref, [slice(0, grids[i][1] * grids[i][2] // 4) for i in range(2)]),
            ("prefill hidden", h_dev, h_ref, "valid"),
            ("int8 suffix-pass hidden", s_dev, s_ref, None),
            ("int8 decode-step hidden", d_dev, d_ref, None),
            ("int8 QI8 decode-step hidden", q_dev, q_ref, None),
        ):
            if rows is None:
                diff, mag = (a - r).abs().max().item(), r.abs().max().item()
            elif rows == "valid":
                diff, mag = (a - r)[valid].abs().max().item(), r[valid].abs().max().item()
            else:
                diff = max((a[i, sl] - r[i, sl]).abs().max().item() for i, sl in enumerate(rows))
                mag = max(r[i, sl].abs().max().item() for i, sl in enumerate(rows))
            rel = diff / mag
            log(f"[reference] tiny {name}, {weights} weights: card bf16 vs CPU float32 max abs err {diff:.3e}, "
                f"relative to max {rel:.3e} (tol {TINY_REL_TOL})")
            if not rel <= TINY_REL_TOL:
                raise AssertionError(f"tiny {name} ({weights} weights) disagrees with the CPU reference: {rel}")


def phase_tiny_train(dev):
    """padt_loss and its gradients on the tiny model (all four losses, a
    batch of two synthetic REC samples built by the data pipeline), with
    the tower frozen and with it trained (per-block remat; H2 with its LSE
    and H8/H9 over its segment and slot ids): bf16 on the card, through
    H1-H3 forward, H2 with its LSE, H8/H9 and H1's VJP, vs float32 on the
    CPU through the twins, from the same weights. Leaves whose reference
    gradient is under 1e-6 of the largest leaf's are printed but not held to
    the relative bound: the attention key biases, whose exact gradient is 0
    (the softmax is blind to a shift of every score of a row), and the last
    decoder block's memory update, which only the mask head reads; bf16
    rounding is all that is left of them."""
    import numpy as np

    from padt_tpu_torch import padt_tiny
    from padt_tpu_torch.models import padt as P
    from padt_tpu_torch.ops import cuda_flash_bwd as FB
    from padt_tpu_torch.tools.profile_train import synthetic_rec
    from padt_tpu_torch.train import train_step as TS
    from padt_tpu_torch.train.data import build_train_batch
    from padt_tpu_torch.utils.mock_tokenizer import make_tiny_tokenizer
    from padt_tpu_torch.vrt.processor import VisionTextProcessor

    cfg = padt_tiny()
    proc = VisionTextProcessor(make_tiny_tokenizer(cfg), cfg, seq_bucket=32, patch_bucket=cfg.max_image_patches)
    proc.prepare(cfg.text.vocab_size)
    rows, images = synthetic_rec(2, grid=(1, 16, 16), seed=3)
    tb = build_train_batch(rows, proc, cfg, np.random.RandomState(0), images=images, canvas_hw=(16, 16))
    p32 = P.init_padt_params(cfg, torch.Generator().manual_seed(2), "cpu", torch.float32)

    def run(device, dtype, frozen):
        params = _tree_to(p32, device, dtype)
        trainable = [(n, t) for n, t in TS.flat_leaves(params) if not (frozen and n.startswith("vision."))]
        for _, t in trainable:
            t.requires_grad_(True)
        batch = {k: torch.as_tensor(v, device=device) for k, v in tb.model.items()}
        loss, _ = TS.padt_loss(params, cfg, batch, tb.prompt_length, tb.meta["canvas_hw"],
                               TS.LossConfig(freeze_vision=frozen), False)
        loss.backward()
        return float(loss), {n: t.grad.float().cpu() for n, t in trainable}

    for frozen in (True, False):
        what = "frozen tower" if frozen else "tower trained"
        n0 = FB.launch_counts["flash_bwd_dkv"]
        loss_ref, g_ref = run("cpu", torch.float32, frozen)
        loss_dev, g_dev = run(dev, torch.bfloat16, frozen)
        torch.cuda.synchronize()
        blocks = cfg.text.num_hidden_layers + (0 if frozen else cfg.vision.depth)
        if FB.launch_counts["flash_bwd_dkv"] - n0 != blocks:
            raise AssertionError(f"the tiny training check ({what}) did not run H9 in every text layer"
                                 + ("" if frozen else " and every tower block") + " on the card")
        rel_loss = abs(loss_dev - loss_ref) / abs(loss_ref)
        norms = {n: float(g.norm()) for n, g in g_ref.items()}
        floor = 1e-6 * max(norms.values())
        rels = {n: float((g_dev[n] - g).norm()) / norms[n] for n, g in g_ref.items() if norms[n] > floor}
        flat_ref = torch.cat([g.flatten() for g in g_ref.values()])
        flat_dev = torch.cat([g_dev[n].flatten() for n in g_ref])
        cos = float(flat_ref @ flat_dev / (flat_ref.norm() * flat_dev.norm()))
        worst = max(rels, key=rels.get)
        tower = [n for n in rels if n.startswith("vision.")]
        tower_txt = "" if frozen else (f"; {len(tower)} tower leaves held, worst "
                                       f"{max(rels[n] for n in tower):.3e} ({max(tower, key=rels.get)})")
        log(f"[reference] tiny padt_loss, {what}, card bf16 vs CPU float32: loss {loss_dev:.5f} vs {loss_ref:.5f} "
            f"(relative {rel_loss:.3e}, tol {TINY_REL_TOL}); gradients of {len(rels)} trainable leaves: worst relative "
            f"norm {rels[worst]:.3e} ({worst}, tol {TINY_GRAD_REL_TOL}), cosine of the whole gradient {cos:.6f} "
            f"(tol >= {TINY_GRAD_COS}){tower_txt}; {len(norms) - len(rels)} leaves under the floor: "
            + ", ".join(f"{n} {norms[n]:.1e}" for n in norms if n not in rels))
        if not frozen and not tower:
            raise AssertionError("the tiny training check held no tower leaf")
        if not (rel_loss <= TINY_REL_TOL and rels[worst] <= TINY_GRAD_REL_TOL and cos >= TINY_GRAD_COS):
            raise AssertionError(f"the tiny training step on the card ({what}) disagrees with the CPU reference")


def _tree_to(tree, device, dtype):
    """A copy of a parameter tree as fresh leaf tensors."""
    return {k: _tree_to(v, device, dtype) if isinstance(v, dict) else v.detach().to(device, dtype).clone() for k, v in tree.items()}


def phase_train(dev, card, params):
    """PaDT-3B SFT on the card through PaDTTrainer.train(): TRAIN_STEPS
    steps of the single-card configuration (profile_train.train_args) on
    `params`, which it updates in place, with the launch counters reset
    just before and read just after. Returns the launch counts."""
    import tempfile

    import numpy as np

    from padt_tpu_torch.tools.profile_train import flops_per_step, make_trainer
    from padt_tpu_torch.train.train_step import flat_leaves, train_step_launches

    with tempfile.TemporaryDirectory() as out:
        cfg, trainer = make_trainer(dev, TRAIN_BATCH * TRAIN_STEPS, out, params=params)
        text_before = {n: t.detach().clone() for n, t in flat_leaves(trainer.params["text"])}
        vision_before = {n: t.detach().clone() for n, t in flat_leaves(trainer.params["vision"])}
        counters = _counters()
        for c in counters:
            c.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _with_rope_shapes({k: v for c in counters for k, v in c.launch_counts.items()})
    peak = torch.cuda.max_memory_allocated() / 1e9
    if trainer.global_step != TRAIN_STEPS or len(metrics) != TRAIN_STEPS:
        raise AssertionError(f"the trainer ran {trainer.global_step} steps, expected {TRAIN_STEPS}")
    for m in metrics:
        if not all(np.isfinite(m[k]) and m[k] > 0 for k in ("loss", "grad_norm", "sft_loss", "bbox_loss", "mask_loss")):
            raise AssertionError(f"train step {m['step']}: a loss or the grad norm is not finite and positive: {m}")
    per_step = {k: n * TRAIN_STEPS for k, n in train_step_launches(cfg).items()}
    if {k: counts[k] for k in per_step} != per_step:
        raise AssertionError(f"train launches {counts}, expected exactly {per_step} ({TRAIN_STEPS} steps)")
    moved, unreached = [], []
    exp_avg = {n: trainer.optimizer.inner.state[t]["exp_avg"] for n, t in trainer.optimizer.leaves}
    for n, t in flat_leaves(trainer.params["text"]):
        if not torch.equal(t.detach(), text_before[n]):
            moved.append(n)
        elif not (bool((text_before[n] == 1).all()) and float(exp_avg["text." + n].abs().max()) > 0):
            unreached.append(n)
    if unreached:
        raise AssertionError(f"trainable text leaves that neither moved nor are bf16 ones reached by a gradient: {unreached}")
    if not all(torch.equal(t, vision_before[n]) for n, t in flat_leaves(trainer.params["vision"])):
        raise AssertionError("the frozen tower changed")
    steps = [m["step_time_s"] for m in metrics[1:]]  # step 1 warms up
    s_step = float(np.mean(steps))
    tokens = TRAIN_BATCH * TRAIN_LEN
    flops = flops_per_step(cfg, trainer.params, TRAIN_BATCH, TRAIN_LEN, TRAIN_LEN - 640, PATCHES, True)
    log(f"[train] padt_3b SFT, frozen tower, AdamW lr 2e-5, batch {TRAIN_BATCH} x {TRAIN_LEN} tokens, all four losses: "
        f"{TRAIN_STEPS} steps in {wall:.2f} s wall; losses " + ", ".join(f"{m['loss']:.4f}" for m in metrics)
        + "; grad norms " + ", ".join(f"{m['grad_norm']:.4f}" for m in metrics) + f"; warm-up {[m['warmup'] for m in metrics]}")
    log(f"[train] s/step {s_step:.4f} (steps 2-{TRAIN_STEPS}: " + ", ".join(f"{x:.4f}" for x in steps) + f"), "
        f"{tokens / s_step:.1f} tokens/s, MFU {flops / s_step / BF16_TENSOR_FLOPS:.4f} ({flops / 1e12:.1f} TFLOP per step "
        f"over {BF16_TENSOR_FLOPS / 1e12:.0f} TFLOP/s), peak {peak:.2f} GB allocated; step 1 {metrics[0]['step_time_s']:.3f} s ({card})")
    log(f"[train] launches {counts} (exactly {TRAIN_STEPS} x {train_step_launches(cfg)}); {len(moved)} text leaves moved, "
        f"{len(text_before) - len(moved)} bf16 ones reached by a gradient but below a bf16 step of 1.0; the tower unchanged")
    del trainer, text_before, vision_before, exp_avg
    return counts


def phase_train_tower(dev, card, params):
    """[train-tower]: PaDT-3B SFT with the tower trained (TrainArgs'
    default) through PaDTTrainer.train(): TRAIN_TOWER_STEPS steps of the
    single-card configuration with freeze_vision_modules=False (AdamW,
    per-block remat of the tower) on `params`, which it updates in place,
    with the launch counters reset just before and read just after. Holds
    the exact launches per step, finite positive losses and grad norms,
    every tower leaf moved (or, for the bf16 norm weights of 1.0, reached by
    a gradient) and the peak memory under the card's 80 GB. Returns the
    launch counts."""
    import tempfile

    import numpy as np

    from padt_tpu_torch.tools.profile_train import flops_per_step, make_trainer
    from padt_tpu_torch.train.train_step import flat_leaves, train_step_launches

    steps = TRAIN_TOWER_STEPS
    with tempfile.TemporaryDirectory() as out:
        cfg, trainer = make_trainer(dev, TRAIN_BATCH * steps, out, params=params, freeze_vision_modules=False)
        if trainer.args.optimizer != "adamw" or trainer.args.freeze_vision_modules:
            raise AssertionError("[train-tower] is the AdamW step with the tower trained")
        vision_before = {n: t.detach().clone() for n, t in flat_leaves(trainer.params["vision"])}
        counters = _counters()
        for c in counters:
            c.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _with_rope_shapes({k: v for c in counters for k, v in c.launch_counts.items()})
    peak = torch.cuda.max_memory_allocated() / 1e9
    if trainer.global_step != steps or len(metrics) != steps:
        raise AssertionError(f"[train-tower] ran {trainer.global_step} steps, expected {steps}")
    for m in metrics:
        if not all(np.isfinite(m[k]) and m[k] > 0 for k in ("loss", "grad_norm", "sft_loss", "bbox_loss", "mask_loss")):
            raise AssertionError(f"[train-tower] step {m['step']}: a loss or the grad norm is not finite and positive: {m}")
    plan = train_step_launches(cfg, freeze_vision=False)
    per_step = {k: n * steps for k, n in plan.items()}
    if {k: counts[k] for k in per_step} != per_step:
        raise AssertionError(f"[train-tower] launches {counts}, expected exactly {per_step} ({steps} steps)")
    moved, unreached = [], []
    exp_avg = {n: trainer.optimizer.inner.state[t]["exp_avg"] for n, t in trainer.optimizer.leaves}
    for n, t in flat_leaves(trainer.params["vision"]):
        if not torch.equal(t.detach(), vision_before[n]):
            moved.append(n)
        elif not (bool((vision_before[n] == 1).all()) and float(exp_avg["vision." + n].abs().max()) > 0):
            unreached.append(n)
    if unreached:
        raise AssertionError(f"[train-tower] tower leaves that neither moved nor are bf16 ones reached by a gradient: {unreached}")
    if not peak < 80.0:
        raise AssertionError(f"[train-tower] peak {peak:.2f} GB allocated: not under the card's 80 GB")
    times = [m["step_time_s"] for m in metrics[1:]]  # step 1 warms up
    s_step = float(np.mean(times))
    tokens = TRAIN_BATCH * TRAIN_LEN
    flops = flops_per_step(cfg, trainer.params, TRAIN_BATCH, TRAIN_LEN, TRAIN_LEN - 640, PATCHES, False)
    log(f"[train-tower] padt_3b SFT, tower trained (per-block remat), AdamW lr 2e-5, batch {TRAIN_BATCH} x {TRAIN_LEN} "
        f"tokens, all four losses: {steps} steps in {wall:.2f} s wall; losses " + ", ".join(f"{m['loss']:.4f}" for m in metrics)
        + "; grad norms " + ", ".join(f"{m['grad_norm']:.4f}" for m in metrics))
    log(f"[train-tower] s/step {s_step:.4f} (steps 2-{steps}: " + ", ".join(f"{x:.4f}" for x in times) + f"), "
        f"{tokens / s_step:.1f} tokens/s, MFU {flops / s_step / BF16_TENSOR_FLOPS:.4f} ({flops / 1e12:.1f} TFLOP per step, the "
        f"tower counted 3x, over {BF16_TENSOR_FLOPS / 1e12:.0f} TFLOP/s), peak {peak:.2f} GB allocated of 80 GB; step 1 "
        f"{metrics[0]['step_time_s']:.3f} s ({card})")
    log(f"[train-tower] launches {counts} (exactly {steps} x {plan}: H2 / H8 / H9 in every tower block, no H3); "
        f"{len(moved)} tower leaves moved, {len(vision_before) - len(moved)} bf16 ones reached by a gradient but below "
        f"a bf16 step of 1.0")
    del trainer, vision_before, exp_avg
    return counts


def _check_completions(name, comps, n, budgets, d):
    """n completions, each with 1..budget tokens and finite hidden states."""
    if len(comps) != n:
        raise AssertionError(f"{name}: {len(comps)} completions for {n} requests")
    for c in comps:
        bud = budgets[c.uid]
        if not (1 <= c.n_gen <= bud and len(c.tokens) == c.n_gen):
            raise AssertionError(f"{name}: request {c.uid} has {c.n_gen} tokens for a budget of {bud}")
        if c.hidden is not None:
            _finite(f"{name} hidden", c.hidden, (NEW_TOKENS, d))


def _check_results(name, results, n):
    if len(results) != n or not all(isinstance(r.completion, str) for r in results):
        raise AssertionError(f"{name}: malformed results")
    for r in results:
        for o in r.objects:
            if not (0.0 <= o.score <= 1.0):
                raise AssertionError(f"{name}: object score {o.score} out of [0, 1]")


def _serve_prompts():
    return [PROMPTS[i % len(PROMPTS)].replace('"the', f'"the {w}') for i, w in enumerate(
        ["big", "small", "old", "new", "left", "right", "top", "blue", "green", "dark", "light", "far", "near", "tall", "short", "round"])]


def _report_serve(tag, card, what, wall, prefill_s, decode_s, tokens, steps, n_req):
    util = tokens / (steps * SERVE_SLOTS) if steps else 0.0
    log(f"[{tag}] {what}: {n_req} requests, {SERVE_SLOTS} slots, bucket {SERVE_BUCKET}: {wall:.3f} s wall, "
        f"device prefill {prefill_s:.3f} s, device decode {decode_s:.3f} s (CUDA events), {tokens} tokens in "
        f"{steps} steps -> {tokens / decode_s:.1f} decode tok/s, {decode_s / max(steps, 1) * 1e3:.3f} ms per step, "
        f"slot utilization {util:.3f} ({card})")


def phase_serve(dev, card, cfg, model, proc):
    """PaDT-3B through the continuous-batching serve engine (int8 KV, packed
    weights): run_stream, ServeEngine.run with mixed budgets, share_prefix
    run_stream and a speculative=4 engine. Returns the launch counts of the
    whole phase, the forward counts that set their floors, and the first
    run_stream (results, wall, stats): [qi8]'s run without QI8."""
    from padt_tpu_torch.eval.harness import InferenceEngine
    from padt_tpu_torch.serve import ServeEngine

    d = cfg.text.hidden_size
    prompts = _serve_prompts()
    images = [_u8_image(100 + i) for i in range(SERVE_REQUESTS)]
    engine = InferenceEngine(model.params, cfg, proc, max_new_tokens=NEW_TOKENS)
    kw = dict(n_slots=SERVE_SLOTS, max_new_tokens=NEW_TOKENS, prompt_len=PROMPT_LEN, prefill_bucket=SERVE_BUCKET,
              patch_bucket=PATCHES, collect_hidden=True)
    forwards = {"decode": 0, "verify": 0, "suffix": 0}
    report = lambda *a: _report_serve("serve", card, *a)

    counters = _counters()
    for c in counters:
        c.reset_launch_counts()
    torch.cuda.synchronize()
    # 1. the user entry point: run_stream of 16 REC requests (prompt bucket 640)
    t0 = time.perf_counter()
    results = engine.run_stream(prompts, images, n_slots=SERVE_SLOTS, prefill_bucket=SERVE_BUCKET, prompt_bucket=PROMPT_LEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_results("run_stream", results, SERVE_REQUESTS)
    sp = engine.pop_stream_stats()
    base = dict(results=results, wall=wall, sp=sp)
    forwards["decode"] += sp["decode_steps"]
    report("run_stream", wall, sp["engine_prefill_s"], sp["engine_decode_s"], sp["generated_tokens"], sp["decode_steps"], SERVE_REQUESTS)
    if sp["generated_tokens"] < SERVE_REQUESTS:
        raise AssertionError(f"run_stream generated {sp['generated_tokens']} tokens for {SERVE_REQUESTS} requests")
    if "qkv_w" not in engine.params["text"]["layers"]:
        raise AssertionError("the serve engine did not run on packed weights")

    # 2. ServeEngine.run with per-request budgets 8..32: slots drain and refill at different steps
    reqs, _ = engine.build_stream_requests(prompts, images, prompt_bucket=PROMPT_LEN)
    budgets = [8 + (24 * ((5 * i) % SERVE_REQUESTS)) // (SERVE_REQUESTS - 1) for i in range(SERVE_REQUESTS)]
    for q, bud in zip(reqs, budgets):
        q.max_new_tokens = bud
    plain = ServeEngine(engine.params, cfg, **kw)
    t0 = time.perf_counter()
    comps, st = plain.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_completions("ServeEngine.run", comps, SERVE_REQUESTS, budgets, d)
    forwards["decode"] += st.decode_steps
    report(f"ServeEngine.run, budgets {min(budgets)}..{max(budgets)}", wall, st.prefill_s, st.decode_s,
           st.generated_tokens, st.decode_steps, SERVE_REQUESTS)

    # 3. share_prefix: 8 prompts over 2 images, one prefix prefill per image + suffix passes
    two = [_u8_image(200), _u8_image(201)]
    n_pfx = 8
    t0 = time.perf_counter()
    results = engine.run_stream(prompts[:n_pfx], [two[i % 2] for i in range(n_pfx)], n_slots=SERVE_SLOTS,
                                prefill_bucket=SERVE_BUCKET, share_prefix=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_results("run_stream(share_prefix=True)", results, n_pfx)
    sp = engine.pop_stream_stats()
    if sp["suffix_passes"] < 1:
        raise AssertionError("share_prefix ran no suffix pass")
    forwards["decode"] += sp["decode_steps"]
    forwards["suffix"] += sp["suffix_passes"]
    report(f"run_stream(share_prefix=True), 2 images, {sp['suffix_passes']} suffix passes", wall,
           sp["engine_prefill_s"], sp["engine_decode_s"], sp["generated_tokens"], sp["decode_steps"], n_pfx)

    # 4. speculative=4: prompt-lookup drafts verified 4 tokens at a time (H5)
    n_spec = SERVE_SLOTS
    spec = ServeEngine(engine.params, cfg, speculative=SPEC_K, **kw)
    t0 = time.perf_counter()
    scomps, sst = spec.run(reqs[:n_spec])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_completions("speculative=4", scomps, n_spec, budgets, d)
    forwards["verify"] += sst.decode_steps
    report("ServeEngine.run speculative=4", wall, sst.prefill_s, sst.decode_s, sst.generated_tokens, sst.decode_steps, n_spec)
    by_uid = {c.uid: c for c in comps}
    same = sum(int(len(c.tokens) == len(by_uid[c.uid].tokens) and (c.tokens == by_uid[c.uid].tokens).all()) for c in scomps)
    log(f"[serve] speculative vs plain greedy: {same} of {n_spec} completions token-identical "
        "(bf16 verify and decode round differently, so a near-tie may flip)")

    counts = _with_rope_shapes(_with_kq({k: v for c in counters for k, v in c.launch_counts.items()}))
    log(f"[serve] launches {counts}; forwards {forwards}")
    return counts, forwards, base


def _with_kq(counts):
    """The launch counts with H5's split by kq (suffix passes, kq = SUFFIX_K;
    speculative verify, kq = SPEC_K), read from the wrapper's own split."""
    from padt_tpu_torch.ops import cuda_kv as K

    for kq in (SUFFIX_K, SPEC_K):
        counts[f"int8_verify_attn kq={kq}"] = K.verify_launches_by_kq.get(kq, 0)
    return counts


def check_serve_launches(cfg, counts, forwards, what="the serve phase"):
    """Every int8 kernel ran on the serve path: H4 in every layer of every
    decode step, H5 in every layer of every suffix / verify pass, H6 once
    after each of them."""
    nl = cfg.text.num_hidden_layers
    passes = forwards["verify"] + forwards["suffix"]
    need = {"int8_decode_attn": nl * forwards["decode"], "store_kv_rows": forwards["decode"] + passes}
    if passes:
        need["int8_verify_attn"] = nl * passes
    for kq, fw in ((SPEC_K, "verify"), (SUFFIX_K, "suffix")):
        if forwards[fw]:
            need[f"int8_verify_attn kq={kq}"] = nl * forwards[fw]
    for k, n in need.items():
        if not (n > 0 and counts[k] >= n):
            raise AssertionError(f"{k} launched {counts[k]} times in {what}, expected >= {n} (> 0)")


def check_launches(cfg, counts, what="run_batch"):
    """Every kernel ran on the main path: once per vision layer of its kind
    and once per text layer in prefill, at least."""
    vc, tc = cfg.vision, cfg.text
    n_full = len(vc.fullatt_block_indexes)
    need = {
        "rope_qk": vc.depth + tc.num_hidden_layers,
        "window_slot_attn": vc.depth - n_full,
        "segment_flash_fwd": n_full + tc.num_hidden_layers,
    }
    for k, n in need.items():
        if counts[k] < n:
            raise AssertionError(f"{k} launched {counts[k]} times in {what}, expected >= {n}")


def check_int8_matmul_launches(cfg, n, forwards, what):
    """H7 ran for the four packed products of every text layer of every
    forward (prefill layer passes, decode steps, suffix passes)."""
    need = 4 * cfg.text.num_hidden_layers * forwards
    if not (need > 0 and n >= need):
        raise AssertionError(f"int8_matmul launched {n} times in {what}, expected >= {need} (> 0)")


def _h7_cases(dev, layers, tag):
    """H7 vs its twin at the 7B products' shapes, M = 4 (a run_batch decode
    step of 4 rows), M = 8 (a serve decode step of 8 slots) and M = 2560 (a
    prefill bucket of 4 x 640), walking the layers'
    own int8 weights from call to call so that each call streams its weight
    from HBM (the walk covers at least three times the 50 MB L2); the
    yardstick is torch._weight_int8pack_mm on the same walk."""
    from padt_tpu_torch.ops import cuda_quant as Q
    from padt_tpu_torch.ops import quant

    def walk(fn, x, argsets):
        """fn(x, *argsets[i]) over i = 0, 1, ...: the first call reads layer 0."""
        nxt = itertools.cycle(argsets).__next__
        return lambda: fn(x, *nxt())

    g = torch.Generator(device=dev).manual_seed(7)
    cases = []
    for name in ("qkv_w", "o_w", "gateup_w", "down_w"):
        wq, s = layers[name + "_q"], layers[name + "_s"]  # (L, K, N) int8, (L, 1, N) fp32
        nl, k, n = wq.shape
        nb = min(nl, max(2, -(-int(L2_WALK_BYTES) // (k * n))))
        ours = [(wq[i], s[i]) for i in range(nb)]
        lib = [(wq[i].t().contiguous(), s[i].reshape(-1).to(torch.bfloat16)) for i in range(nb)]  # (N, K) int8, (N,) bf16
        for m in (BATCH, SERVE_SLOTS, BATCH * PROMPT_LEN):
            x = (torch.randn((m, k), generator=g, device=dev) * 0.5).to(torch.bfloat16)
            cases.append(dict(
                name="int8_matmul", path="7b", source="int8_matmul.cu", replaces="padt_tpu/ops/quant.py:70", tol=TOL, relative=True,
                norm=True,
                shape=f"{tag}{name}_q M={m} x K={k} x N={n} ({nb} layers' weights in turn)",
                kern=walk(Q.int8_matmul, x, ours), plain=walk(quant.int8_matmul_plain, x, ours),
                library=walk(torch._weight_int8pack_mm, x, lib),
                bound=(m * k * 2 + k * n + n * 4 + m * n * 2, 2 * m * n * k, BF16_TENSOR_FLOPS),
            ))
    return cases


def phase_7b(dev, card):
    """PaDT-7B with int8 packed text-layer weights at full depth and width:
    H7's kernel lines on the model's own weights, then run_batch (bf16 KV)
    and run_stream (int8 KV), each with the launch counters reset just
    before and read just after. Returns (H7 entries, {kernel: launches})."""
    from padt_tpu_torch import padt_7b
    from padt_tpu_torch.eval.harness import InferenceEngine
    from padt_tpu_torch.models import padt as P
    from padt_tpu_torch.ops import cuda_quant as Q

    cfg = padt_7b()
    t0 = time.perf_counter()
    params = P.init_padt_params_quantized(cfg, torch.Generator(device=dev).manual_seed(0), dev, torch.bfloat16, packed=True)
    torch.cuda.synchronize()
    leaves = P.PaDTModel(cfg, params).state_dict().values()
    layer_bytes = sum(t.numel() * t.element_size() for t in params["text"]["layers"].values())
    log(f"[7b] padt_7b random weights, int8 packed text layers: {sum(t.numel() for t in leaves) / 1e9:.3f} B params, "
        f"{sum(t.numel() * t.element_size() for t in leaves) / 1e9:.3f} GB ({layer_bytes / 1e9:.3f} GB text layers) "
        f"in {time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated ({card})")
    entries = measure(_h7_cases(dev, params["text"]["layers"], "7B "), card)

    proc = _processor(cfg)
    counters = _counters()
    counts_b, _ = phase_run_batch("7b", dev, card, cfg, params, proc)
    check_launches(cfg, counts_b, "the 7B run_batch")
    # one prefill pass and NEW_TOKENS - 1 decode steps, unless every row hit EOS early
    check_int8_matmul_launches(cfg, counts_b["int8_matmul"], NEW_TOKENS, "the 7B run_batch")

    engine = InferenceEngine(params, cfg, proc, max_new_tokens=NEW_TOKENS)
    prompts, images = _serve_prompts(), [_u8_image(300 + i) for i in range(SERVE_REQUESTS)]
    for c in counters:
        c.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.run_stream(prompts, images, n_slots=SERVE_SLOTS, prefill_bucket=SERVE_BUCKET, prompt_bucket=PROMPT_LEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts_s = _with_rope_shapes(_with_kq({k: v for c in counters for k, v in c.launch_counts.items()}))
    log(f"[7b] run_stream H7 launches by M {dict(sorted(Q.launches_by_m.items()))}")
    _check_results("7B run_stream", results, SERVE_REQUESTS)
    sp = engine.pop_stream_stats()
    _report_serve("7b", card, "run_stream, int8 weights", wall, sp["engine_prefill_s"], sp["engine_decode_s"],
                  sp["generated_tokens"], sp["decode_steps"], SERVE_REQUESTS)
    log(f"[7b] run_stream launches {counts_s}; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated ({card})")
    if sp["generated_tokens"] < SERVE_REQUESTS:
        raise AssertionError(f"7B run_stream generated {sp['generated_tokens']} tokens for {SERVE_REQUESTS} requests")
    if "qkv_w_q" not in engine.params["text"]["layers"]:
        raise AssertionError("the 7B serve engine did not run on int8 packed weights")
    check_serve_launches(cfg, counts_s, {"decode": sp["decode_steps"], "verify": 0, "suffix": sp["suffix_passes"]}, "the 7B run_stream")
    # each admission prefills at most SERVE_BUCKET requests
    n_prefill = -(-SERVE_REQUESTS // SERVE_BUCKET)
    check_int8_matmul_launches(cfg, counts_s["int8_matmul"], n_prefill + sp["decode_steps"] + sp["suffix_passes"], "the 7B run_stream")
    launches = {k: counts_b.get(k, 0) + counts_s.get(k, 0) for k in set(counts_b) | set(counts_s)}
    return entries, launches


def phase_forms(dev, card, cfg):
    """[forms]: the op-level API of `ops.kv_cache` in its older forms (no
    fresh_kv) at the serve pool's shape over the 3B's layers, with the launch
    counters reset just before and read just after:
      1. a decode step as those forms compose it: per layer, store_kv_rows
         (layer=, K17) lands the token's row, then decode_attention_int8
         (layer=, K14) reads the updated cache;
      2. a 32-token suffix pass on a second cache: store_kv_rows_k (layer=,
         K18), then decode_attention_int8_multi (layer=, K16);
      3. one unstacked layer: store_kv_rows, decode_attention_int8 (K13),
         decode_attention_int8(n_valid=) (K15), store_kv_rows_k,
         decode_attention_int8_multi.
    1 and 2 agree within TOL with the serve path's fresh forms (K6, K8) on
    the pre-update caches, computed before the counted run; every output is
    finite; the launches are exact. Returns the launch counts."""
    from padt_tpu_torch.ops import kv_cache as KC

    tc = cfg.text
    nl, hkv, hd, h = tc.num_hidden_layers, tc.num_key_value_heads, tc.head_dim, tc.num_attention_heads
    b, cap = KV_SLOTS, KV_CAP
    g = torch.Generator(device=dev).manual_seed(11)
    kv = _kv(dev, g, hd)
    rnd = lambda *shape: (torch.randn(shape, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    caches = [kv(nl, b, hkv, cap), None]
    caches[1] = [t.clone() for t in caches[0]]
    cols = torch.arange(cap, device=dev)[None, :]
    lens = torch.randint(PROMPT_LEN - 100, cap - SUFFIX_K, (b,), generator=g, device=dev)
    pos = lens.int()
    valid = (cols < lens[:, None]) & (cols >= 40)
    valid1 = valid | (cols == lens[:, None])
    valid32 = valid | ((cols >= lens[:, None]) & (cols < lens[:, None] + SUFFIX_K))
    rows1, rows32 = kv(nl, b, hkv, 1), kv(nl, b, hkv, SUFFIX_K)
    q1, q32 = rnd(b, 1, h, hd), rnd(b, SUFFIX_K, h, hd)
    at = lambda rows, li: tuple(t[li] for t in rows)
    with torch.inference_mode():
        ref1 = [KC.decode_attention_int8(q1, *caches[0], valid, layer=li, fresh_kv=at(rows1, li)) for li in range(nl)]
        ref32 = [KC.decode_attention_int8_multi(q32, *caches[1], valid, pos, layer=li, fresh_kv=at(rows32, li)) for li in range(nl)]
        uni = [t[0].clone() for t in caches[0]]  # one unstacked layer
        counters = _counters()
        for c in counters:
            c.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out1, out32 = [], []
        for li in range(nl):
            KC.store_kv_rows(*caches[0], *at(rows1, li), pos, layer=li)
            out1.append(KC.decode_attention_int8(q1, *caches[0], valid1, layer=li))
        for li in range(nl):
            KC.store_kv_rows_k(*caches[1], *at(rows32, li), pos, layer=li)
            out32.append(KC.decode_attention_int8_multi(q32, *caches[1], valid32, pos, layer=li))
        KC.store_kv_rows(*uni, *at(rows1, 0), pos)
        u13 = KC.decode_attention_int8(q1, *uni, valid1)
        u15 = KC.decode_attention_int8(q1, *uni, valid1, n_valid=lens + 1)
        KC.store_kv_rows_k(*uni, *at(rows32, 0), pos)
        u16 = KC.decode_attention_int8_multi(q32, *uni, valid32, pos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {k: v for c in counters for k, v in c.launch_counts.items()}
    need = {"int8_decode_attn": nl + 2, "int8_decode_attn_qi8": 0, "int8_verify_attn": nl + 1, "store_kv_rows": 2 * nl + 2}
    if {k: counts[k] for k in need} != need:
        raise AssertionError(f"[forms] launches {counts}, expected exactly {need}")
    for name, t, shape in (("K13", u13, q1.shape), ("K15", u15, q1.shape), ("K16 unstacked", u16, q32.shape)):
        _finite(f"[forms] {name}", t, shape)
    err1 = max((o.float() - r.float()).abs().max().item() for o, r in zip(out1, ref1))
    err32 = max((o.float() - r.float()).abs().max().item() for o, r in zip(out32, ref32))
    err13 = (u13.float() - out1[0].float()).abs().max().item()  # the same cache as layer 0 of step 1
    err15 = (u15.float() - u13.float()).abs().max().item()  # n_valid past every live row: the same rows
    log(f"[forms] {nl} layers x (store_kv_rows + decode_attention_int8) and x (store_kv_rows_k + decode_attention_int8_multi) "
        f"at {b} slots, capacity {cap}, plus the unstacked forms: {wall * 1e3:.2f} ms wall; vs the fresh forms on the "
        f"pre-update caches: decode max abs err {err1:.3e}, suffix {err32:.3e}; unstacked K13 vs layer 0 {err13:.3e}, "
        f"K15 vs K13 {err15:.3e} (tol {TOL}); launches {counts} ({card})")
    if not max(err1, err32, err13, err15) <= TOL:
        raise AssertionError("[forms] the older int8 KV forms disagree with the fresh forms")
    return counts


def _report_gen_qi8(tag, card, label, ms, toks, base_toks):
    same = float((toks == base_toks).float().mean())
    log(f"[{tag}] {label}: {ms:.2f} ms; greedy tokens equal to the run without QI8 at {same:.4f} of positions "
        f"(random weights: printed, not held) ({card})")


def phase_qi8(dev, card, cfg, model, proc, base):
    """[qi8]: PaDT-3B served with PADT_DECODE_QI8's int8 x int8 decode scores
    (`ops.kv_cache._QI8_DEFAULT` set, the flag the variable sets at import),
    through the entry points a user calls and no new argument: int8
    `generate` of BATCH REC queries, and `run_stream` of SERVE_REQUESTS
    requests over SERVE_SLOTS slots (no share_prefix, no speculative: those
    refuse QI8, as JAX's do). With the counters reset before and read after
    each run: H4-QI8 exactly once per layer and decode step, H4's bf16 mode
    and H5 never; finite outputs. The runs without QI8 are the same generate,
    run first, and the [serve] phase's first run_stream (`base`: the same
    requests, images and slots); the share of greedy tokens each pair agrees
    on is printed, not held (random weights). Returns the launch counts of
    the QI8 runs."""
    from padt_tpu_torch.eval.harness import InferenceEngine
    from padt_tpu_torch.models import padt as P
    from padt_tpu_torch.ops import kv_cache as KC

    nl = cfg.text.num_hidden_layers
    prompts, images = PROMPTS[:BATCH], [_u8_image(i) for i in range(BATCH)]
    batch = proc.build_batch(prompts, images, patch_bucket=PATCHES, prompt_bucket=PROMPT_LEN)
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.data.items()}
    deltas = torch.as_tensor(batch.rope_deltas, device=dev)
    packed = P.pack_inference_params(model.params)
    sprompts, simages = _serve_prompts(), [_u8_image(100 + i) for i in range(SERVE_REQUESTS)]  # as phase_serve's
    counters = _counters()
    runs = {}
    before = KC._QI8_DEFAULT
    try:
        for qi8 in (False, True):
            KC._QI8_DEFAULT = qi8
            for c in counters:
                c.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                gen = P.generate(packed, cfg, tb, NEW_TOKENS, deltas, eos_token_id=-1, kv_cache_dtype="int8")
            torch.cuda.synchronize()
            gen_ms = (time.perf_counter() - t0) * 1e3
            runs[qi8] = dict(gen=gen, gen_ms=gen_ms, gcounts={k: v for c in counters for k, v in c.launch_counts.items()})
        engine = InferenceEngine(model.params, cfg, proc, max_new_tokens=NEW_TOKENS)
        for c in counters:
            c.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run_stream(sprompts, simages, n_slots=SERVE_SLOTS, prefill_bucket=SERVE_BUCKET, prompt_bucket=PROMPT_LEN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        scounts = {k: v for c in counters for k, v in c.launch_counts.items()}
        sp = engine.pop_stream_stats()
        del engine
    finally:
        KC._QI8_DEFAULT = before
    r0, r1 = runs[False], runs[True]
    _finite("[qi8] generate hidden", r1["gen"].hidden, (BATCH, NEW_TOKENS, cfg.text.hidden_size))
    if int(r1["gen"].num_generated.min()) != NEW_TOKENS:
        raise AssertionError("[qi8] generate did not emit every token")
    _check_results("[qi8] run_stream", results, SERVE_REQUESTS)
    steps = sp["decode_steps"]
    need_g = {"int8_decode_attn_qi8": nl * (NEW_TOKENS - 1), "int8_decode_attn": 0, "int8_verify_attn": 0}
    need_s = {"int8_decode_attn_qi8": nl * steps, "int8_decode_attn": 0, "int8_verify_attn": 0}
    for what, counts, need in (("generate", r1["gcounts"], need_g), ("run_stream", scounts, need_s)):
        if steps < 1 or {k: counts[k] for k in need} != need:
            raise AssertionError(f"[qi8] {what} launches {counts}, expected exactly {need}")
    if r0["gcounts"]["int8_decode_attn_qi8"]:
        raise AssertionError("[qi8] the generate without QI8 launched the QI8 mode")
    _report_gen_qi8("qi8", card, f"int8 generate of {BATCH} x {NEW_TOKENS} tokens, QI8 (without: {r0['gen_ms']:.2f} ms)",
                    r1["gen_ms"], r1["gen"].tokens, r0["gen"].tokens)
    same = sum(a.completion == b.completion for a, b in zip(results, base["results"]))
    _report_serve("qi8", card, "run_stream with PADT_DECODE_QI8", wall, sp["engine_prefill_s"], sp["engine_decode_s"],
                  sp["generated_tokens"], steps, SERVE_REQUESTS)
    log(f"[qi8] run_stream completions equal to [serve]'s run_stream without QI8: {same} of {SERVE_REQUESTS} (printed, "
        f"not held); that run {base['wall']:.3f} s wall, {base['sp']['engine_decode_s']:.3f} s device decode; launches {scounts}")
    return {k: r1["gcounts"][k] + scounts[k] for k in scounts}


PIPELINE_IMAGES = 8  # PNGs the [pipeline] phase writes and runs through tools/infer_eval.py infer


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _pipeline_data(root):
    """8 random 644x644 PNGs (PIL imports on the card) and the processed JSONL
    / COCO annotations that name them: one object per image, a box, its RLE
    mask and a label from PROMPTS."""
    import numpy as np
    import PIL.Image

    from padt_tpu_torch.eval import rle

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    rng = np.random.RandomState(7)
    side = GRID[1] * 14
    rows, cats = [], {}
    for i in range(PIPELINE_IMAGES):
        PIL.Image.fromarray(rng.randint(0, 256, (side, side, 3), np.uint8)).save(os.path.join(img_dir, f"{i}.png"))
        label = PROMPTS[i % len(PROMPTS)].split('"')[1]
        cats.setdefault(label, len(cats) + 1)
        x1, y1 = rng.randint(0, side // 2, 2)
        w, h = rng.randint(28, side // 2, 2)
        mask = np.zeros((side, side), np.uint8)
        mask[y1 : y1 + h, x1 : x1 + w] = 1
        rows.append({
            "id": i, "image": f"{i}.png", "answer_template": 'The "x" refers to <|Obj_0|> in this image.',
            "conversations": [{"from": "human", "value": "<image>" + PROMPTS[i % len(PROMPTS)]}],
            "objects": [{"bbox": [x1 / side, y1 / side, (x1 + w) / side, (y1 + h) / side], "area": float(w * h),
                         "iscrowd": 0, "label": label, "rle": rle.encode(mask)}],
        })
    data = os.path.join(root, "pipeline_val.jsonl")
    with open(data, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    coco = os.path.join(root, "instances_pipeline.json")
    with open(coco, "w") as f:
        json.dump({"categories": [{"id": c, "name": n} for n, c in cats.items()],
                   "images": [{"id": r["id"], "height": side, "width": side} for r in rows]}, f)
    return img_dir, data, coco


def phase_pipeline(dev, card, cfg, params, proc, slice_results):
    """[pipeline]: the released-checkpoint path on PaDT-3B's [slice] weights,
    through the entry points a user calls: `save_hf_checkpoint` writes them
    as an HF directory (4 GiB shards + index), `tools/convert_checkpoint`
    turns it into the native format, `api.load_model` loads each directory
    onto the card (every leaf bit-equal to [slice]'s by key, same dtype, on
    cuda); an `InferenceEngine` on the loaded weights with [slice]'s
    processor runs [slice]'s run_batch (completions equal to [slice]'s, H1-H3
    at their floors) and run_stream of 8 requests (H4 and H6 at their
    floors), each with the launch counters reset just before and read just
    after; then `tools/infer_eval.py infer --engine stream` runs 8 PNGs the
    phase writes (PIL imports on the card) into prediction JSONL through
    infer_dataset's writer, and `tools/infer_eval.py score` scores them as
    COCO and as RefCOCO against the ground truth the phase writes (printed:
    random weights). The temporary directories go in a `finally`; any
    failure propagates."""
    import shutil
    import tempfile

    from padt_tpu_torch import api
    from padt_tpu_torch.convert.padt_to_hf import save_hf_checkpoint
    from padt_tpu_torch.eval.harness import InferenceEngine
    from padt_tpu_torch.tools import convert_checkpoint, infer_eval

    want = _flat(params)
    root = tempfile.mkdtemp(prefix="padt_pipeline_")
    try:
        hf, native = os.path.join(root, "hf"), os.path.join(root, "native")
        t0 = time.perf_counter()
        save_hf_checkpoint(hf, params, cfg)
        t_export = time.perf_counter() - t0
        shards = sorted(f for f in os.listdir(hf) if f.endswith(".safetensors"))
        gb = sum(os.path.getsize(os.path.join(hf, f)) for f in shards) / 1e9
        log(f"[pipeline] save_hf_checkpoint: {gb:.3f} GB in {len(shards)} shards + index in {t_export:.1f} s ({card})")
        if len(shards) < 2 or not os.path.exists(os.path.join(hf, "model.safetensors.index.json")):
            raise AssertionError(f"[pipeline] expected 4 GiB shards and an index, got {sorted(os.listdir(hf))}")
        t0 = time.perf_counter()
        if convert_checkpoint.main(["--src", hf, "--dst", native]) != 0:
            raise AssertionError("[pipeline] convert_checkpoint failed")
        t_convert = time.perf_counter() - t0
        gb_native = os.path.getsize(os.path.join(native, api.NATIVE_PARAMS)) / 1e9
        log(f"[pipeline] tools/convert_checkpoint HF -> native (host): {gb_native:.3f} GB in {t_convert:.1f} s ({card})")

        loaded = None
        for what, path in (("HF", hf), ("native", native)):
            del loaded
            gc.collect()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lcfg, loaded, _ = api.load_model(path, device=dev)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            if lcfg != cfg:
                raise AssertionError(f"[pipeline] the {what} checkpoint's config differs from [slice]'s: {lcfg}")
            got = _flat(loaded)
            if set(got) != set(want):
                raise AssertionError(f"[pipeline] {what} keys differ: {sorted(set(got) ^ set(want))[:8]}")
            for k, v in want.items():
                g = got[k]
                if g.dtype != v.dtype or g.device != v.device or g.shape != v.shape or not torch.equal(g, v):
                    raise AssertionError(f"[pipeline] {what} leaf {k} is not [slice]'s ({g.dtype} {g.device} {tuple(g.shape)})")
            log(f"[pipeline] api.load_model({what}) onto {dev}: {len(got)} leaves bit-equal to [slice]'s by key, "
                f"{t_load:.1f} s ({card})")

        counters = _counters()
        engine = InferenceEngine(loaded, cfg, proc, max_new_tokens=NEW_TOKENS)
        for c in counters:
            c.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run_batch(PROMPTS[:BATCH], [_u8_image(i) for i in range(BATCH)], prompt_bucket=PROMPT_LEN)
        torch.cuda.synchronize()
        wall_b = time.perf_counter() - t0
        counts_b = _with_rope_shapes({k: v for c in counters for k, v in c.launch_counts.items()})
        check_launches(cfg, counts_b, "the [pipeline] run_batch")
        if [r.completion for r in results] != [r.completion for r in slice_results]:
            raise AssertionError("[pipeline] run_batch on the loaded weights differs from [slice]'s completions")
        n_obj = sum(len(r.objects) for r in results)
        log(f"[pipeline] run_batch on the loaded weights: {BATCH} completions equal to [slice]'s, {n_obj} objects, "
            f"{wall_b:.3f} s wall; launches {counts_b} ({card})")

        n_req = 8
        for c in counters:
            c.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sresults = engine.run_stream(_serve_prompts()[:n_req], [_u8_image(100 + i) for i in range(n_req)],
                                     n_slots=SERVE_SLOTS, prefill_bucket=SERVE_BUCKET, prompt_bucket=PROMPT_LEN)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts_s = _with_rope_shapes(_with_kq({k: v for c in counters for k, v in c.launch_counts.items()}))
        _check_results("[pipeline] run_stream", sresults, n_req)
        sp = engine.pop_stream_stats()
        check_serve_launches(cfg, counts_s, {"decode": sp["decode_steps"], "verify": 0, "suffix": sp["suffix_passes"]},
                             "the [pipeline] run_stream")
        log(f"[pipeline] run_stream of {n_req} requests on the loaded weights: {wall_s:.3f} s wall, "
            f"{sp['decode_steps']} decode steps; launches {counts_s} ({card})")
        del engine, loaded
        gc.collect()
        torch.cuda.empty_cache()

        img_dir, data, coco = _pipeline_data(root)
        out = os.path.join(root, "eval")
        t0 = time.perf_counter()
        infer_eval.main(["infer", "--model", native, "--data", data, "--image_folder", img_dir, "--output_dir", out,
                         "--dataset", "pipeline", "--suffix", "chip", "--batch_size", str(PIPELINE_IMAGES),
                         "--max_new_tokens", str(NEW_TOKENS), "--engine", "stream", "--n_slots", str(SERVE_SLOTS),
                         "--prefill_bucket", str(SERVE_BUCKET), "--device", str(dev)])
        t_infer = time.perf_counter() - t0
        preds = os.path.join(out, "pipeline_*_pred_results_chip.json")
        with open(os.path.join(out, "pipeline_0_pred_comp_chip.json")) as f:
            n_comp = sum(1 for _ in f)
        if n_comp != PIPELINE_IMAGES:
            raise AssertionError(f"[pipeline] infer wrote {n_comp} completions for {PIPELINE_IMAGES} images")
        coco_stats = infer_eval.main(["score", "--task", "coco", "--pred_glob", preds, "--processed_json", data,
                                      "--coco_json", coco])
        ref_stats = infer_eval.main(["score", "--task", "refcoco", "--pred_glob", preds, "--processed_json", data])
        log(f"[pipeline] tools/infer_eval.py infer (load_model + infer_dataset, stream engine) of {PIPELINE_IMAGES} "
            f"PNGs: {t_infer:.1f} s wall; score: COCO AP {coco_stats['AP']} AP50 {coco_stats['AP50']}, RefCOCO "
            f"ap50 {ref_stats['ap50']} ciou {ref_stats['ciou']} mask_ap50 {ref_stats['mask_ap50']} over "
            f"{ref_stats['num_gt']} ground-truth objects (random weights) ({card})")
    finally:
        shutil.rmtree(root, ignore_errors=True)


STREAM_B = 96  # decode rows of the [stream] phase (the JAX micro-benchmark's B)


def _h10_cases(dev, layers, tcfg):
    """H10 vs its plain version at PaDT-3B's four decode products, M =
    STREAM_B, fused (qkv with its bias, gate-up) and unfused, walking the 36
    layers' weights from call to call; the yardstick is
    torch.nn.functional.linear, after torch.nn.functional.rms_norm where
    fused: two PyTorch calls."""
    import torch.nn.functional as F

    from padt_tpu_torch.ops import matmul as MM

    g = torch.Generator(device=dev).manual_seed(13)
    eps, nl = tcfg.rms_norm_eps, tcfg.num_hidden_layers
    cases = []
    for name, ln_name, bias_name in (("qkv_w", "input_ln_w", "qkv_b"), ("o_w", None, None),
                                     ("gateup_w", "post_ln_w", None), ("down_w", None, None)):
        w = layers[name]
        _, k, n = w.shape
        x = (torch.randn((STREAM_B, k), generator=g, device=dev) * 0.5).to(torch.bfloat16)
        for fused in ((False, True) if ln_name else (False,)):
            ln = layers[ln_name] if fused else None
            bias = layers[bias_name] if bias_name else None

            def walk(fn, ln=ln, bias=bias, x=x, w=w):  # bound now: the loop rebinds x and w
                it = itertools.cycle(range(nl)).__next__
                return lambda: fn(x, w, it(), ln_w=ln, bias=bias, eps=eps)

            def library(ln=ln, bias=bias, k=k, x=x, w=w):
                it = itertools.cycle(range(nl)).__next__

                def call():
                    i = it()
                    xx = F.rms_norm(x, (k,), ln[i], eps) if ln is not None else x
                    return F.linear(xx, w[i].t(), None if bias is None else bias[i])

                return call

            calls = "rms_norm + linear, two calls" if fused else "linear, one call"
            cases.append(dict(
                name="stream_matmul", path="stream", source="stream_matmul.cu", replaces="padt_tpu/ops/matmul.py:76",
                tol=TOL, relative=True, norm=True,
                shape=f"{name} M={STREAM_B} x K={k} x N={n}{', rms_norm fused' if fused else ''}{', bias' if bias is not None else ''} "
                      f"({nl} layers' weights in turn; library: {calls})",
                kern=walk(MM.stream_matmul_stacked), plain=walk(MM.stream_matmul_stacked_ref), library=library(),
                bound=(STREAM_B * k * 2 + k * n * 2 + (k * 2 if fused else 0) + (n * 2 if bias is not None else 0)
                       + STREAM_B * n * 2, 2 * STREAM_B * n * k, BF16_TENSOR_FLOPS),
            ))
    return cases


def phase_stream(dev, card):
    """[stream]: `tools/micro_stream_matmul.py` at PaDT-3B, B = STREAM_B,
    all 36 layers (K19's entry point): each variant's device ms and GB/s
    per pass; H10 launched exactly 4 x 36 times by one pass of each stream
    variant (the counts are differences around that eager pass) and never
    by the torch variant; each variant's output no farther from the float32
    loop than twice the torch variant's (the bf16 rounding over 36 layers is
    the yardstick); then H10's kernel lines on the same weights. Returns the
    entries and {"stream_matmul": launches of one stream pass}."""
    from padt_tpu_torch import padt_3b
    from padt_tpu_torch.ops import cuda_matmul
    from padt_tpu_torch.tools import micro_stream_matmul as tool

    tcfg = padt_3b().text
    nl = tcfg.num_hidden_layers
    cuda_matmul.reset_launch_counts()
    layers = tool.make_layers(tcfg, dev)
    res, _ = tool.run(tcfg, STREAM_B, dev, reps=10, layers=layers)
    bound = res["weight_bytes"] / HBM_BYTES_PER_S * 1e3
    for name in tool.VARIANTS:
        log(f"[stream] {name}: {res[f'{name}_ms']:.4f} ms per {nl}-layer pass at B={STREAM_B}, "
            f"{res[f'{name}_gbps']:.1f} GB/s over {res['weight_bytes'] / 1e9:.3f} GB of bf16 weights "
            f"(bound {bound:.4f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); H10 launches per pass {res[f'{name}_launches']}; "
            f"max abs gap from the float32 loop {res[f'gap_f32_{name}']:.4f} ({card})")
    log(f"[stream] max abs gap from the torch variant: stream {res['max_gap_stream']:.4f}, stream_noln "
        f"{res['max_gap_stream_noln']:.4f}, of outputs up to {res['max_abs_torch']:.4f}")
    want = {"torch": 0, "stream": 4 * nl, "stream_noln": 4 * nl}
    if {k: res[f"{k}_launches"] for k in want} != want:
        raise AssertionError(f"[stream] H10 launches per pass {[res[f'{k}_launches'] for k in want]}, expected {want}")
    for name in ("stream", "stream_noln"):
        if not res[f"gap_f32_{name}"] <= 2 * res["gap_f32_torch"]:
            raise AssertionError(f"[stream] {name} is farther from the float32 loop than twice the torch variant: {res}")
    entries = measure(_h10_cases(dev, layers, tcfg), card)
    del layers
    return entries, {"stream_matmul": res["stream_launches"]}


MOE_D, MOE_E, MOE_F, MOE_K, MOE_LAYERS = 2048, 128, 768, 8, 48  # Keye-VL-2.0-30B-A3B's expert layers


def phase_moe(dev, card):
    """[moe]: H11, the grouped expert GEMM (csrc/expert_matmul.cu), against
    its plain twin at Keye-VL-2.0-30B-A3B's widths (d 2048, 128 experts of
    768, 8 a token, seeded router and weights of std 0.02) at a serve decode step
    (32 slots: 256 choices) and admission (bucket 4 x 640: 20480 choices):
    both products (gate-up with SiLU fused, down with the routing weight),
    each output within TOL of its largest, and a relative norm gap within
    NORM_TOL; device ms of the two launches, of the twin and the bound (the
    experts hit read once, each row's activations in and out; operations
    2 x rows x 3 d F); launches on the serve path: two a layer, 96 a
    forward (decode step or admission). One layer's experts (1.2 GB) exceed
    the L2, so every call reads them from HBM."""
    from padt_tpu_torch.ops import cuda_moe
    from padt_tpu_torch.ops import moe as M

    d, e, f, k = MOE_D, MOE_E, MOE_F, MOE_K
    g = torch.Generator(device=dev).manual_seed(17)
    gate_up = (0.02 * torch.randn(e, d, 2 * f, generator=g, device=dev)).to(torch.bfloat16)
    down = (0.02 * torch.randn(e, f, d, generator=g, device=dev)).to(torch.bfloat16)
    router = 0.02 * torch.randn(d, e, generator=g, device=dev)
    for tokens, what in ((32, "decode step, 32 slots"), (2560, "admission, 4 x 640")):
        x = torch.randn(tokens, d, generator=g, device=dev).to(torch.bfloat16)
        w, ids = M.route(x, router, k, True)
        grp = M.group(w, ids, e)
        hit = int(grp.ends.diff(prepend=grp.ends.new_zeros(1)).gt(0).sum())
        kern = lambda: cuda_moe.expert_matmul(cuda_moe.expert_matmul(x, gate_up, grp, "gateup"), down, grp, "down")
        plain = lambda: M.expert_matmul_plain(M.expert_matmul_plain(x, gate_up, grp, "gateup"), down, grp, "down")
        out, ref = kern(), plain()
        gap = (out.float() - ref.float()).abs().max().item()
        rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        if not (gap <= TOL * ref.float().abs().max().item() and rel <= NORM_TOL):
            raise AssertionError(f"[moe] H11 at {tokens} tokens: max gap {gap}, relative norm gap {rel}")
        n0 = cuda_moe.launch_counts["expert_matmul"]
        ms_k, ms_p = cuda_ms(kern), cuda_ms(plain, iters=3, warmup=1)
        rows = tokens * k
        b_ms, bound_by = bound_ms(hit * 3 * d * f * 2 + rows * 2 * (d + f) * 2, 2 * rows * 3 * d * f, BF16_TENSOR_FLOPS)
        plans = [cuda_moe.expert_plan(tokens, k, e, kk, nw, mode == "gateup") for mode, kk, nw in (("gateup", d, 2 * f), ("down", f, d))]
        plans = "; ".join(f"swap {p.swap} nt {p.nt} tile {p.tile_m} x {p.tile_n} stages {p.stages} grid {p.grid}" for p in plans)
        log(f"[moe] H11 at {what} ({rows} choices, {hit} of {e} experts hit): {ms_k:.4f} ms device for both products "
            f"({plans}), bound {b_ms:.4f} ms ({bound_by}; {100 * b_ms / ms_k:.1f} %), "
            f"plain {ms_p:.4f} ms; max gap {gap:.5f}, norm gap {rel:.5f}; {cuda_moe.launch_counts['expert_matmul'] - n0} "
            f"launches timed; on the serve path 2 a layer, {2 * MOE_LAYERS} a forward ({card})")


def _gemm_kernels(fn):
    """{device kernel name: launches} of `fn()` under `torch.profiler`, the
    port's own kernels (namespace `padt`) and PyTorch's elementwise kernels
    left out: the library GEMMs a form runs."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return Counter(e.name[:96] for e in prof.events() if e.device_type == cuda and "padt::" not in e.name
                   and "at::native" not in e.name)


def phase_tower_mlp(dev, card):
    """[tower-mlp]: one PaDT-3B tower block's MLP (`models/vision.py::_mlp`:
    x + the MLP of its norm, d 1280, ff 3420) at 4 x 2304 rows, random
    weights and biases: the plain layout (three GEMMs at ff, whose rows
    are not 16-byte aligned, bias adds, SiLU and multiply) and the packed
    one at F' = 3424 (the least aligned width) and 3456 (a multiple of 64;
    two GEMMs with their biases in the epilogue, H12 between). Each packed
    output within NORM_TOL of the plain one in relative norm; device ms
    (CUDA events) beside the bound of the three products at ff; the library
    GEMM kernels each form launches, and `sm80` whether any of the packed
    forms' names carries `cutlass_80` or `align2` (the packed ones must
    not). The forms run in turns, three rounds of 30 calls; the median of
    each is printed. Then H12's kernel lines (returned) at the port's width
    (`packed_ff(ff)`, 3424), 4 x 2304 rows and 333 ragged rows."""
    import dataclasses

    from padt_tpu_torch import padt_3b
    from padt_tpu_torch.models import vision as V
    from padt_tpu_torch.ops import cuda_mlp

    vc = padt_3b().vision
    d, ff, m = vc.hidden_size, vc.intermediate_size, 4 * PATCHES
    g = torch.Generator(device=dev).manual_seed(20)
    blocks = V.init_vision_params(dataclasses.replace(vc, depth=1), g, dev, torch.bfloat16)["blocks"]
    for k in ("gate_b", "up_b", "down_b"):
        blocks[k] = (0.1 * torch.randn(blocks[k].shape, generator=g, device=dev)).to(torch.bfloat16)
    x = torch.randn(4, PATCHES, d, generator=g, device=dev).to(torch.bfloat16)
    layer = lambda b: {k: v[0] for k, v in b.items()}
    forms = [("plain", ff, layer(blocks))] + [
        (f"packed {V.packed_ff(ff, mult)}", V.packed_ff(ff, mult), layer(V.pack_vision_blocks(blocks, mult)))
        for mult in (8, 64)
    ]
    ref = V._mlp(x, x, forms[0][2]).float()
    mlp_weights = [forms[0][2][k] for k in ("gate_w", "up_w", "down_w", "gate_b", "up_b", "down_b")]
    b_ms, b_by = bound_ms(nbytes(*mlp_weights) + 2 * nbytes(x), 2 * m * d * ff * 3, BF16_TENSOR_FLOPS)
    fns = [lambda lp=lp: V._mlp(x, x, lp) for _, _, lp in forms]
    ms = [[] for _ in forms]
    for _ in range(3):  # the forms in turns, three rounds: the median of each
        for i, fn in enumerate(fns):
            ms[i].append(cuda_ms(fn, iters=30))
    times = []
    for (name, width, lp), fn, t in zip(forms, fns, ms):
        gap = ((fn().float() - ref).norm() / ref.norm()).item()
        if not gap <= NORM_TOL:
            raise AssertionError(f"[tower-mlp] {name}: relative norm gap {gap} from the plain form > {NORM_TOL}")
        kernels = _gemm_kernels(fn)
        sm80 = any("cutlass_80" in k or "align2" in k for k in kernels)
        if name != "plain" and sm80:
            raise AssertionError(f"[tower-mlp] {name} ran an sm80 / align2 GEMM: {dict(kernels)}")
        med = sorted(t)[1]
        times.append(f"{name} {med:.4f} ms")
        log(f"[tower-mlp] {name} (width {width}): {med:.4f} ms device (rounds {', '.join(f'{v:.4f}' for v in t)}), "
            f"{b_ms / med:.3f} of the bound; norm gap {gap:.2e} from the plain form; sm80 {sm80}; library kernels "
            f"{dict(kernels)} ({card})")
    log(f"[tower-mlp] one block's MLP at {m} rows: {', '.join(times)}; bound {b_ms:.4f} ms ({b_by}: 3 products "
        f"of {m} x {d} x {ff}); the port packs to {V.packed_ff(ff)} ({card})")

    cases = []
    for rows in (m, 333):
        gu = torch.randn(rows, 2 * V.packed_ff(ff), generator=g, device=dev).to(torch.bfloat16)
        cases.append({
            "name": "swiglu", "shape": f"{rows} x {V.packed_ff(ff)}", "path": "3b_serve", "ulp": True, "tol": TOL,
            "kern": lambda gu=gu: cuda_mlp.swiglu(gu), "plain": lambda gu=gu: cuda_mlp.swiglu_plain(gu),
            "bound": (nbytes(gu) * 3 // 2, 0, BF16_TENSOR_FLOPS), "source": "swiglu.cu",
            "replaces": "none: XLA fuses silu(gate) * up (padt_tpu/models/vision.py :141-143)",
        })
    return measure(cases, card)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import padt_tpu_torch  # sets the float32 matmul/cuDNN flags

    t0 = [time.perf_counter()]

    def stamp(what):  # host seconds of each phase, for the run's time budget
        t = time.perf_counter()
        log(f"[time] {what}: {t - t0[0]:.1f} s")
        t0[0] = t

    dev = torch.device("cuda", 0)
    name, card = phase_device()
    entries = phase_kernels(dev, card)
    phase_gqa(dev, card)
    phase_moe(dev, card)
    entries += phase_tower_mlp(dev, card)
    stamp("build + kernel lines")
    forms_counts = phase_forms(dev, card, padt_tpu_torch.padt_3b())
    phase_tiny_reference(dev)
    phase_tiny_train(dev)
    stamp("forms + tiny references")
    cfg, model, proc = load_3b(dev)
    counts, slice_results = phase_run_batch("slice", dev, card, cfg, model.params, proc)
    check_launches(cfg, counts)
    stamp("3B load + run_batch")
    serve_counts, forwards, serve_base = phase_serve(dev, card, cfg, model, proc)
    check_serve_launches(cfg, serve_counts, forwards)
    stamp("serve")
    qi8_counts = phase_qi8(dev, card, cfg, model, proc, serve_base)
    stamp("qi8")
    phase_pipeline(dev, card, cfg, model.params, proc, slice_results)
    gc.collect()
    torch.cuda.empty_cache()
    stamp("pipeline")
    params = model.params
    del model, proc
    gc.collect()
    train_counts = phase_train(dev, card, params)  # trains the same 3B weights in place
    gc.collect()
    torch.cuda.empty_cache()
    stamp("train")
    tower_counts = phase_train_tower(dev, card, params)  # and again, with the tower trained
    del params
    gc.collect()
    torch.cuda.empty_cache()
    stamp("train-tower")
    h7_entries, counts_7b = phase_7b(dev, card)
    entries += h7_entries
    gc.collect()
    torch.cuda.empty_cache()
    stamp("7b")
    h10_entries, stream_counts = phase_stream(dev, card)
    entries += h10_entries
    stamp("stream")
    # each kernel's launches on its own path (H1's at the line's own shape): the 3B run_batch for H1-H3, 3B
    # serving for H4-H6, the older KV forms' op-level run for K13-K18, the QI8
    # serve runs for H4's QI8 mode, the 3B train steps for the training
    # lines (the trained tower's for its H2 / H8 / H9 lines), the 7B runs for
    # the 7B shapes and H7, one stream pass for H10
    paths = {"3b_batch": counts, "3b_serve": serve_counts, "forms": forms_counts, "3b_qi8": qi8_counts,
             "train": train_counts, "train_tower": tower_counts, "7b": counts_7b, "stream": stream_counts}
    kernels, yardsticks = [], []
    for e in entries:
        path, key = e.pop("path"), e.pop("launch_key")
        if path is None:  # a layout no path runs yet: timed and checked, launched 0 times on the main paths
            yardsticks.append({**e, "launches": 0})
        else:
            n = paths[path].get(key, 0)
            if n <= 0:  # the line's shape is one its path runs (H1's lines: by rows and heads)
                raise AssertionError(f"{e['name']} [{e['shape']}]: no launch under {key!r} on path {path}")
            kernels.append({**e, "launches": n})
    log(json.dumps({"yardsticks": yardsticks}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
