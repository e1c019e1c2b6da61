#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`padt_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `padt_tpu_torch/csrc` (nvcc, sm_90a,
into build/padt_tpu_torch/), then:
  1. prints the card (nvidia-smi name and power limit, torch device name);
  2. holds each kernel against its plain PyTorch twin at the shapes the main
     path gives it (bf16, max abs error over all rows, tolerance 2e-2:
     bf16 output rounding plus a different order of sums), and times both
     with CUDA events;
  3. runs PaDT-3B REC inference through `InferenceEngine.run_batch` (random
     weights from a seeded generator, 4 prompts over 644px-class images of
     46x46 patches, 32 new tokens) with the launch counters reset just
     before and read just after, runs `vl_decode` on 4 forced objects,
     checks every output is finite and of the expected shape, checks the
     vision tower and prefill on a tiny model against the plain float32 CPU
     path, and times vision, prefill and decode;
  4. prints the kernels' JSON line, then the result line
     {"ok": true, "device": {...}} last.
Any failure raises, and the script exits non-zero without the result line.
It needs CUDA; it imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 2e-2  # bf16 outputs of magnitude ~1: output rounding + sum order
TINY_REL_TOL = 5e-2  # tiny model in bf16 with kernels vs float32 plain path
GRID = (1, 46, 46)  # a 644x644 image in 14px patches
PATCHES = 2304
PROMPT_LEN = 640
NEW_TOKENS = 32
BATCH = 4


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


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(f"[device] torch: {name}, count {torch.cuda.device_count()}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    return name, smi


def phase_kernels(dev, card):
    """Each kernel vs its twin at main-path shapes; one entry per TPU kernel replaced."""
    from padt_tpu.models.vision_geom import vision_geometry
    from padt_tpu_torch.ops import _build
    from padt_tpu_torch.ops import cuda_attention as C
    from padt_tpu_torch.ops.rope import mrope_cos_sin, vision_rope_cos_sin

    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] {_build.library_path().relative_to(ROOT)} ready in {time.perf_counter() - t0:.1f} s")

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
    l, th, tkv, thd = PROMPT_LEN, 16, 2, 128
    pos = torch.arange(l, device=dev)[None].expand(b, l) - torch.tensor([[100], [0]], device=dev)
    tcos, tsin = mrope_cos_sin(pos.clamp(min=0)[None].expand(3, b, l), thd, (16, 24, 24))
    tq, tk, tv = rnd(b, l, th * thd), rnd(b, l, tkv, thd), rnd(b, l, tkv, thd)
    tseg = (pos >= 0).int() - 1  # row 0 left-padded by 100 tokens: seg -1
    vqr, vkr = C.rope_qk(vq, vk, vcos, vsin, h, h)
    u = lambda t: t.unflatten(-1, (h, hd))

    cases = [
        ("rope_qk", "vision 2x2304x(16+16)x80, q/k views of the fused qkv", "padt_tpu/ops/pallas_attention.py:700",
         lambda: C.rope_qk(vq, vk, vcos, vsin, h, h), lambda: C.rope_qk_plain(vq, vk, vcos, vsin, h, h)),
        ("rope_qk", "text 2x640x(16+2)x128", "padt_tpu/ops/pallas_attention.py:574",
         lambda: C.rope_qk(tq, tk.flatten(2), tcos, tsin, th, tkv),
         lambda: C.rope_qk_plain(tq, tk.flatten(2), tcos, tsin, th, tkv)),
        ("segment_flash_fwd", "text prefill causal GQA 2x640, 16/2 heads x128, left pad 100", "padt_tpu/ops/pallas_attention.py:65",
         lambda: C.segment_flash_fwd(tq.unflatten(-1, (th, thd)), tk, tv, tseg, tseg, True, thd**-0.5),
         lambda: C.segment_flash_plain(tq.unflatten(-1, (th, thd)), tk, tv, tseg, tseg, True, thd**-0.5)),
        ("segment_flash_fwd", "vision full layer 2x2304x16x80 on seg_full", "padt_tpu/ops/pallas_attention.py:769",
         lambda: C.segment_flash_fwd(u(vqr), u(vkr), u(vv), seg_full, seg_full, False, hd**-0.5),
         lambda: C.segment_flash_plain(u(vqr), u(vkr), u(vv), seg_full, seg_full, False, hd**-0.5)),
        ("window_slot_attn", "vision windowed layer 2x2304x16x80 on seg_win", "padt_tpu/ops/pallas_attention.py:860",
         lambda: C.window_slot_attn(u(vqr), u(vkr), u(vv), seg_win, hd**-0.5),
         lambda: C.window_slot_plain(u(vqr), u(vkr), u(vv), seg_win, hd**-0.5)),
    ]
    sources = {"rope_qk": "rope_qk.cu", "segment_flash_fwd": "segment_flash.cu", "window_slot_attn": "window_attn.cu"}
    entries = []
    for name, shape, replaces, kern, plain in cases:
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        err = max((a.float() - r.float()).abs().max().item() for a, r in zip(outs, refs))
        if not err <= TOL:
            raise AssertionError(f"{name} [{shape}]: max abs err {err} > {TOL}")
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        log(f"[kernel] {name} [{shape}]: max_abs_err {err:.3e} (tol {TOL}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({card})")
        entries.append({
            "name": name, "route": "cuda", "source": f"padt_tpu_torch/csrc/{sources[name]}",
            "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "shape": shape,
        })
    return entries


def _u8_image(seed):
    import numpy as np

    from padt_tpu.preprocess.vision_process import ProcessedImage

    t, gh, gw = GRID
    rows = np.random.RandomState(seed).randint(0, 256, (t * gh * gw, 3 * 14 * 14)).astype(np.uint8)
    return ProcessedImage(pixel_patches=None, grid_thw=GRID, pixel_patches_u8=rows)


def _finite(name, t, shape=None):
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise AssertionError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not torch.isfinite(t.float()).all():
        raise AssertionError(f"{name}: non-finite values")


def phase_slice(dev, card):
    """PaDT-3B REC through run_batch; returns the kernels' launch counts."""
    from padt_tpu.config import padt_3b
    from padt_tpu.utils.mock_tokenizer import make_full_tokenizer
    from padt_tpu.vrt.processor import VisionTextProcessor
    from padt_tpu_torch.eval.harness import InferenceEngine
    from padt_tpu_torch.models import language
    from padt_tpu_torch.models import padt as P
    from padt_tpu_torch.ops import cuda_attention as C

    cfg = padt_3b()
    assert cfg.max_image_patches == PATCHES
    t0 = time.perf_counter()
    params = P.init_padt_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, torch.bfloat16)
    model = P.PaDTModel(cfg, params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in model.state_dict().values())
    log(f"[slice] padt_3b random weights: {n_params / 1e9:.3f} B params bf16 in {time.perf_counter() - t0:.1f} s")
    proc = VisionTextProcessor(make_full_tokenizer(cfg), cfg)
    proc.prepare(cfg.text.vocab_size)
    prompts = [
        'Please locate "the red car" in the image.',
        'Where is "the man on the left"?',
        'Find "the dog next to the bench".',
        'Locate "the second cup from the right".',
    ][:BATCH]
    images = [_u8_image(i) for i in range(BATCH)]
    engine = InferenceEngine(model.params, cfg, proc, max_new_tokens=NEW_TOKENS)

    C.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.run_batch(prompts, images, prompt_bucket=PROMPT_LEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(C.launch_counts)
    log(f"[slice] run_batch of {BATCH} REC queries: {wall:.3f} s wall ({card}); launches {counts}")
    vc, tc = cfg.vision, cfg.text
    if len(results) != BATCH or not all(isinstance(r.completion, str) for r in results):
        raise AssertionError("run_batch returned malformed results")
    for r in results:
        for o in r.objects:
            if not (0.0 <= o.score <= 1.0):
                raise AssertionError(f"object score {o.score} out of [0, 1]")
    n_obj = sum(len(r.objects) for r in results)
    log(f"[slice] completions[0][:80] {results[0].completion[:80]!r}; objects parsed {n_obj}")

    # timed phases through the same public functions, and finiteness checks
    batch = proc.build_batch(prompts, images, patch_bucket=PATCHES, prompt_bucket=PROMPT_LEN)
    tb = engine._to_device(batch.data)
    deltas = torch.as_tensor(batch.rope_deltas, device=dev)
    with torch.inference_mode():
        def vision():
            return P.run_vision(model.params, cfg, tb)

        def vision_prefill():
            art = vision()
            emb = P.extended_embed(model.params, cfg, tb["input_ids"], art.proto, art.merged)
            return language.prefill(
                model.params["text"], tc, emb, tb["position_ids"], tb["attention_mask"].bool(),
                PROMPT_LEN + NEW_TOKENS,
            )

        t_vis = cuda_ms(vision, iters=3, warmup=1, hide_host=False)
        t_vp = cuda_ms(vision_prefill, iters=3, warmup=1, hide_host=False)
        gen = None

        def full():
            nonlocal gen
            gen = model.generate(tb, NEW_TOKENS, deltas, eos_token_id=-1)

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
        # the decoder at 3B width on 4 forced objects: hidden rows of the first 8 steps
        k = 8
        feats = torch.zeros((cfg.max_objects, cfg.max_vrt_per_object, d), dtype=gen.hidden.dtype, device=dev)
        feats[:BATCH, :k] = gen.hidden[:, :k]
        counts_o = torch.zeros((cfg.max_objects,), dtype=torch.int32, device=dev)
        counts_o[:BATCH] = k
        valid_o = counts_o > 0
        sample_o = torch.zeros((cfg.max_objects,), dtype=torch.int64, device=dev)
        sample_o[:BATCH] = torch.arange(BATCH, device=dev)
        t0 = time.perf_counter()
        dec = model.vl_decode(feats, counts_o, valid_o, sample_o, art)
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
    log(f"[slice] vision {t_vis:.2f} ms, prefill {prefill_ms:.2f} ms (vision+prefill {t_vp:.2f} ms), "
        f"generate {t_gen:.2f} ms, decode {decode_ms:.2f} ms = generate - (vision+prefill) for "
        f"{NEW_TOKENS} tokens x {BATCH} rows -> {BATCH * NEW_TOKENS / (decode_ms / 1e3):.1f} tok/s; "
        f"vl_decode {BATCH} objects (bucket {cfg.max_objects}) {t_dec * 1e3:.2f} ms; batch {BATCH}, prompt {PROMPT_LEN}, bf16 KV ({card})")
    return counts


def phase_tiny_reference(dev):
    """Tiny model: vision tower + prefill on the card (bf16, kernels) vs the
    plain float32 path on the CPU, same weights."""
    import numpy as np

    from padt_tpu.config import padt_tiny
    from padt_tpu.preprocess.vision_process import ProcessedImage
    from padt_tpu.utils.mock_tokenizer import make_tiny_tokenizer
    from padt_tpu.vrt.processor import VisionTextProcessor
    from padt_tpu_torch.models import language
    from padt_tpu_torch.models import padt as P
    from padt_tpu_torch.ops import cuda_attention as C

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

    def run(params, device):
        tb = {k: torch.as_tensor(v, device=device) for k, v in batch.data.items()}
        with torch.inference_mode():
            art = P.run_vision(params, cfg, tb)
            emb = P.extended_embed(params, cfg, tb["input_ids"], art.proto, art.merged)
            valid = tb["attention_mask"].bool()
            hid, _ = language.prefill(params["text"], cfg.text, emb, tb["position_ids"], valid, valid.shape[1])
        return art.merged.float().cpu(), hid.float().cpu(), valid.cpu()

    n0 = sum(C.launch_counts.values())
    m_ref, h_ref, valid = run(p32, "cpu")
    m_dev, h_dev, _ = run(p16, dev)
    if sum(C.launch_counts.values()) == n0:
        raise AssertionError("tiny reference run launched no kernel on the card")
    errs = []
    for name, a, r, rows in (
        ("merged", m_dev, m_ref, [slice(0, grids[i][1] * grids[i][2] // 4) for i in range(2)]),
        ("prefill hidden", h_dev, h_ref, None),
    ):
        if rows is None:
            diff, mag = (a - r)[valid].abs().max().item(), r[valid].abs().max().item()
        else:
            diff = max((a[i, sl] - r[i, sl]).abs().max().item() for i, sl in enumerate(rows))
            mag = max(r[i, sl].abs().max().item() for i, sl in enumerate(rows))
        rel = diff / mag
        errs.append(rel)
        log(f"[reference] tiny {name}: card bf16 vs CPU float32 max abs err {diff:.3e}, relative to max {rel:.3e} (tol {TINY_REL_TOL})")
        if not rel <= TINY_REL_TOL:
            raise AssertionError(f"tiny {name} disagrees with the CPU reference: {rel}")


def check_launches(counts):
    """Every kernel ran on the main path: once per vision layer of its kind
    and once per text layer in prefill, at least."""
    from padt_tpu.config import padt_3b

    vc, tc = padt_3b().vision, padt_3b().text
    n_full = len(vc.fullatt_block_indexes)
    need = {
        "rope_qk": vc.depth + tc.num_hidden_layers,
        "window_slot_attn": vc.depth - n_full,
        "segment_flash_fwd": n_full + tc.num_hidden_layers,
    }
    for k, n in need.items():
        if counts[k] < n:
            raise AssertionError(f"{k} launched {counts[k]} times in run_batch, expected >= {n}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import padt_tpu_torch  # noqa: F401  (sets the float32 matmul/cuDNN flags)

    dev = torch.device("cuda", 0)
    name, card = phase_device()
    entries = phase_kernels(dev, card)
    phase_tiny_reference(dev)
    counts = phase_slice(dev, card)
    check_launches(counts)
    for e in entries:
        e["launches"] = counts[e["name"]]
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
