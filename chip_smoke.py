#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`padt_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `padt_tpu_torch/csrc` (nvcc, sm_90a,
one process per source, into build/padt_tpu_torch/), then:
  1. prints the card (nvidia-smi name and power limit, torch device name);
  2. holds each kernel against its plain PyTorch twin at the shapes the main
     paths give it (bf16 attention outputs: max abs error over all rows,
     tolerance 2e-2, bf16 output rounding plus a different order of sums;
     the int8 row store: byte-identical), and times both with CUDA events;
  3. checks the vision tower, bf16 prefill, int8 prefill, one int8 suffix
     pass and one int8 decode step of a tiny model on the card against the
     plain float32 CPU path;
  4. runs PaDT-3B REC inference through `InferenceEngine.run_batch` (random
     weights from a seeded generator, 4 prompts over 644px-class images of
     46x46 patches, 32 new tokens, bf16 KV) with the launch counters reset
     just before and read just after, runs `vl_decode` on 4 forced objects,
     checks every output is finite and of the expected shape, and times
     vision, prefill and decode;
  5. serves PaDT-3B through the continuous-batching engine (int8 KV, packed
     weights, 8 slots): `run_stream` of 16 REC requests, `ServeEngine.run`
     with budgets of 8..32 tokens, `run_stream(share_prefix=True)` of 8
     prompts over 2 images, and a speculative=4 engine run, with the launch
     counters reset just before and read just after; checks the outputs and
     the launch floors, and prints wall, device prefill / decode seconds,
     decode tok/s and slot utilization;
  6. prints the kernels' JSON line, then the result line
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
SERVE_SLOTS = 8  # decode slots of the serve pool
SERVE_REQUESTS = 16
SERVE_BUCKET = 4  # requests per admission (prefill) bucket
KV_SLOTS, KV_CAP = 16, 768  # int8 kernel lines: a 16-slot pool, capacity 640 + 32 rounded to 128
SUFFIX_K = 32  # rows of a suffix pass (H5's kq, H6's widest store)


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
    from padt_tpu_torch.ops import cuda_kv as K
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

    # the int8 serve path: 36 layers of a 16-slot pool, capacity 768, each
    # slot with its own live length; H4 reads one layer with one fresh column,
    # H5 the same with kq = 32 (a suffix pass), H6 lands every layer's rows.
    # H4 / H5 (and their twins) walk the layers in turn, one per call, as a
    # decode step does: the 226 MB cache cycles through the 50 MB L2, so each
    # call reads its layer from HBM, as on the main path
    import itertools

    from padt_tpu.config import padt_3b

    nl, slots, cap, gq = padt_3b().text.num_hidden_layers, KV_SLOTS, KV_CAP, th // tkv
    i8 = lambda *shape: torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
    sc = lambda *shape: torch.exp(torch.randn(shape, generator=g, device=dev) * 0.4 - 4.0)
    kv = lambda *lead: (i8(*lead, thd), sc(*lead), i8(*lead, thd), sc(*lead))  # (k8, ks, v8, vs)
    cache = kv(nl, slots, tkv, cap)
    lens = torch.randint(PROMPT_LEN - 100, cap - SUFFIX_K, (slots,), generator=g, device=dev)
    valid = torch.arange(cap, device=dev)[None, :] < lens[:, None]
    valid[:, :40] = False  # left padding
    fresh1, fresh32 = kv(slots, tkv, 1), kv(slots, tkv, SUFFIX_K)
    qd, qv = rnd(slots, tkv, gq, thd), rnd(slots, tkv, gq * SUFFIX_K, thd)
    rows1, rows32 = kv(nl, slots, tkv, 1), kv(nl, slots, tkv, SUFFIX_K)
    pos = lens.int()
    one = torch.ones(slots, dtype=torch.int32, device=dev)
    n32 = torch.randint(0, SUFFIX_K + 1, (slots,), generator=g, device=dev, dtype=torch.int32)
    n32[:2] = torch.tensor([0, SUFFIX_K], dtype=torch.int32, device=dev)
    kbuf, pbuf = [t.clone() for t in cache], [t.clone() for t in cache]  # the stores write in place

    def walk(fn, *head, tail=()):
        """fn(*head, layer, *tail) over layers 0, 1, ...: the kernel's and the
        twin's first calls (the comparison) both read layer 0."""
        nxt = itertools.cycle(range(nl)).__next__
        return lambda: fn(*head, nxt(), *tail)

    def store(fn, buf, rows, n):
        return lambda: (fn(*buf, *rows, pos, n), buf)[1]

    cases = [
        ("rope_qk", "vision 2x2304x(16+16)x80, q/k views of the fused qkv", "padt_tpu/ops/pallas_attention.py:700", TOL,
         lambda: C.rope_qk(vq, vk, vcos, vsin, h, h), lambda: C.rope_qk_plain(vq, vk, vcos, vsin, h, h)),
        ("rope_qk", "text 2x640x(16+2)x128", "padt_tpu/ops/pallas_attention.py:574", TOL,
         lambda: C.rope_qk(tq, tk.flatten(2), tcos, tsin, th, tkv),
         lambda: C.rope_qk_plain(tq, tk.flatten(2), tcos, tsin, th, tkv)),
        ("segment_flash_fwd", "text prefill causal GQA 2x640, 16/2 heads x128, left pad 100", "padt_tpu/ops/pallas_attention.py:65", TOL,
         lambda: C.segment_flash_fwd(tq.unflatten(-1, (th, thd)), tk, tv, tseg, tseg, True, thd**-0.5),
         lambda: C.segment_flash_plain(tq.unflatten(-1, (th, thd)), tk, tv, tseg, tseg, True, thd**-0.5)),
        ("segment_flash_fwd", "vision full layer 2x2304x16x80 on seg_full", "padt_tpu/ops/pallas_attention.py:769", TOL,
         lambda: C.segment_flash_fwd(u(vqr), u(vkr), u(vv), seg_full, seg_full, False, hd**-0.5),
         lambda: C.segment_flash_plain(u(vqr), u(vkr), u(vv), seg_full, seg_full, False, hd**-0.5)),
        ("window_slot_attn", "vision windowed layer 2x2304x16x80 on seg_win", "padt_tpu/ops/pallas_attention.py:860", TOL,
         lambda: C.window_slot_attn(u(vqr), u(vkr), u(vv), seg_win, hd**-0.5),
         lambda: C.window_slot_plain(u(vqr), u(vkr), u(vv), seg_win, hd**-0.5)),
        ("int8_decode_attn", f"decode {slots} slots x 2 kv heads x 8 q x128, int8 cache {nl}x{cap} (layers in turn), 1 fresh column",
         "padt_tpu/ops/kv_cache.py:206", TOL,
         walk(K.int8_decode_attn, qd, *cache, *fresh1, valid), walk(K.int8_decode_attn_plain, qd, *cache, *fresh1, valid)),
        ("int8_verify_attn", f"suffix pass {slots} slots x 2 kv heads x (8x{SUFFIX_K}) q x128, int8 cache {nl}x{cap} (layers in turn), {SUFFIX_K} fresh columns",
         "padt_tpu/ops/kv_cache.py:402", TOL,
         walk(K.int8_verify_attn, qv, *cache, *fresh32, valid, tail=(SUFFIX_K,)),
         walk(K.int8_verify_attn_plain, qv, *cache, *fresh32, valid, tail=(SUFFIX_K,))),
        ("store_kv_rows", f"decode store: 1 row per slot x {nl} layers x {slots} slots x 2 kv heads, capacity {cap}",
         "padt_tpu/ops/kv_cache.py:750", 0.0,
         store(K.store_kv_rows, kbuf, rows1, one), store(K.store_kv_rows_plain, pbuf, rows1, one)),
        ("store_kv_rows", f"suffix store: n_rows in [0, {SUFFIX_K}] per slot x {nl} layers x {slots} slots x 2 kv heads",
         "padt_tpu/ops/kv_cache.py:856", 0.0,
         store(K.store_kv_rows, kbuf, rows32, n32), store(K.store_kv_rows_plain, pbuf, rows32, n32)),
    ]
    sources = {
        "rope_qk": "rope_qk.cu", "segment_flash_fwd": "segment_flash.cu", "window_slot_attn": "window_attn.cu",
        "int8_decode_attn": "int8_kv.cu", "int8_verify_attn": "int8_kv.cu", "store_kv_rows": "int8_kv.cu",
    }
    entries = []
    for name, shape, replaces, tol, kern, plain in cases:
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        outs = out if isinstance(out, (tuple, list)) else (out,)
        refs = ref if isinstance(ref, (tuple, list)) else (ref,)
        err = max((a.float() - r.float()).abs().max().item() for a, r in zip(outs, refs))
        if not err <= tol:
            raise AssertionError(f"{name} [{shape}]: max abs err {err} > {tol}")
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        log(f"[kernel] {name} [{shape}]: max_abs_err {err:.3e} (tol {tol}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({card})")
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


PROMPTS = [
    'Please locate "the red car" in the image.',
    'Where is "the man on the left"?',
    'Find "the dog next to the bench".',
    'Locate "the second cup from the right".',
]


def load_3b(dev):
    """PaDT-3B at full depth and width, random bf16 weights from a seed."""
    from padt_tpu.config import padt_3b
    from padt_tpu.utils.mock_tokenizer import make_full_tokenizer
    from padt_tpu.vrt.processor import VisionTextProcessor
    from padt_tpu_torch.models import padt as P

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
    return cfg, model, proc


def phase_slice(dev, card, cfg, model, proc):
    """PaDT-3B REC through run_batch; returns the kernels' launch counts."""
    from padt_tpu_torch.eval.harness import InferenceEngine
    from padt_tpu_torch.models import language
    from padt_tpu_torch.models import padt as P
    from padt_tpu_torch.ops import cuda_attention as C

    prompts = PROMPTS[:BATCH]
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
    """Tiny model on the card (bf16, kernels) vs the plain float32 path on the
    CPU, same weights: the vision tower and bf16-KV prefill, then the int8
    serve path (int8 prefill into a 2-slot pool, one 32-wide suffix pass
    through H5 + H6, one decode step through H4 + H6)."""
    import numpy as np

    from padt_tpu.config import padt_tiny
    from padt_tpu.preprocess.vision_process import ProcessedImage
    from padt_tpu.utils.mock_tokenizer import make_tiny_tokenizer
    from padt_tpu.vrt.processor import VisionTextProcessor
    from padt_tpu_torch.models import language
    from padt_tpu_torch.models import padt as P
    from padt_tpu_torch.ops import cuda_attention as C
    from padt_tpu_torch.ops import cuda_kv as K
    from padt_tpu_torch.serve import engine as S

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
    sfx_len, step_ids = [5, 3], [[11], [12]]

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
            S.insert(st, S.prefill(params, cfg, tb, T(batch.rope_deltas), cap), T([0, 1]), T([4, 4]))
            S._suffix_prefill_step(params, cfg, st, T(sfx_ids), T(sfx_len))
            h_sfx = st.cur_hidden.float().cpu()
            h_step = S._decode_step_slots(params["text"], cfg.text, P.extended_embed(params, cfg, T(step_ids), st.proto), st)
        return art.merged.float().cpu(), hid.float().cpu(), valid.cpu(), h_sfx, h_step.float().cpu()

    n0, n0_kv = sum(C.launch_counts.values()), sum(K.launch_counts.values())
    m_ref, h_ref, valid, s_ref, d_ref = run(p32, "cpu")
    m_dev, h_dev, _, s_dev, d_dev = run(p16, dev)
    if sum(C.launch_counts.values()) == n0 or sum(K.launch_counts.values()) == n0_kv:
        raise AssertionError("tiny reference run launched no kernel on the card")
    errs = []
    for name, a, r, rows in (
        ("merged", m_dev, m_ref, [slice(0, grids[i][1] * grids[i][2] // 4) for i in range(2)]),
        ("prefill hidden", h_dev, h_ref, "valid"),
        ("int8 suffix-pass hidden", s_dev, s_ref, None),
        ("int8 decode-step hidden", d_dev, d_ref, None),
    ):
        if rows is None:
            diff, mag = (a - r).abs().max().item(), r.abs().max().item()
        elif rows == "valid":
            diff, mag = (a - r)[valid].abs().max().item(), r[valid].abs().max().item()
        else:
            diff = max((a[i, sl] - r[i, sl]).abs().max().item() for i, sl in enumerate(rows))
            mag = max(r[i, sl].abs().max().item() for i, sl in enumerate(rows))
        rel = diff / mag
        errs.append(rel)
        log(f"[reference] tiny {name}: card bf16 vs CPU float32 max abs err {diff:.3e}, relative to max {rel:.3e} (tol {TINY_REL_TOL})")
        if not rel <= TINY_REL_TOL:
            raise AssertionError(f"tiny {name} disagrees with the CPU reference: {rel}")


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


def phase_serve(dev, card, cfg, model, proc):
    """PaDT-3B through the continuous-batching serve engine (int8 KV, packed
    weights): run_stream, ServeEngine.run with mixed budgets, share_prefix
    run_stream and a speculative=4 engine. Returns the launch counts of the
    whole phase and the forward counts that set their floors."""
    from padt_tpu_torch.eval.harness import InferenceEngine
    from padt_tpu_torch.ops import cuda_attention as C
    from padt_tpu_torch.ops import cuda_kv as K
    from padt_tpu_torch.serve import ServeEngine

    d = cfg.text.hidden_size
    prompts = [PROMPTS[i % len(PROMPTS)].replace('"the', f'"the {w}') for i, w in enumerate(
        ["big", "small", "old", "new", "left", "right", "top", "blue", "green", "dark", "light", "far", "near", "tall", "short", "round"])]
    images = [_u8_image(100 + i) for i in range(SERVE_REQUESTS)]
    engine = InferenceEngine(model.params, cfg, proc, max_new_tokens=NEW_TOKENS)
    kw = dict(n_slots=SERVE_SLOTS, max_new_tokens=NEW_TOKENS, prompt_len=PROMPT_LEN, prefill_bucket=SERVE_BUCKET,
              patch_bucket=PATCHES, collect_hidden=True)
    forwards = {"decode": 0, "verify": 0, "suffix": 0}

    def report(what, wall, prefill_s, decode_s, tokens, steps, n_req):
        util = tokens / (steps * SERVE_SLOTS) if steps else 0.0
        log(f"[serve] {what}: {n_req} requests, {SERVE_SLOTS} slots, bucket {SERVE_BUCKET}: {wall:.3f} s wall, "
            f"device prefill {prefill_s:.3f} s, device decode {decode_s:.3f} s (CUDA events), {tokens} tokens in "
            f"{steps} steps -> {tokens / decode_s:.1f} decode tok/s, slot utilization {util:.3f} ({card})")

    C.reset_launch_counts()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    # 1. the user entry point: run_stream of 16 REC requests (prompt bucket 640)
    t0 = time.perf_counter()
    results = engine.run_stream(prompts, images, n_slots=SERVE_SLOTS, prefill_bucket=SERVE_BUCKET, prompt_bucket=PROMPT_LEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_results("run_stream", results, SERVE_REQUESTS)
    sp = engine.pop_stream_stats()
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
    spec = ServeEngine(engine.params, cfg, speculative=4, **kw)
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

    counts = {**C.launch_counts, **K.launch_counts}
    log(f"[serve] launches {counts}; forwards {forwards}")
    return counts, forwards


def check_serve_launches(counts, forwards):
    """Every int8 kernel ran on the serve path: H4 in every layer of every
    decode step, H5 in every layer of every suffix / verify pass, H6 once
    after each of them."""
    from padt_tpu.config import padt_3b

    nl = padt_3b().text.num_hidden_layers
    passes = forwards["verify"] + forwards["suffix"]
    need = {
        "int8_decode_attn": nl * forwards["decode"],
        "int8_verify_attn": nl * passes,
        "store_kv_rows": forwards["decode"] + passes,
    }
    for k, n in need.items():
        if not (n > 0 and counts[k] >= n):
            raise AssertionError(f"{k} launched {counts[k]} times in the serve phase, expected >= {n} (> 0)")


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
    cfg, model, proc = load_3b(dev)
    counts = phase_slice(dev, card, cfg, model, proc)
    check_launches(counts)
    serve_counts, forwards = phase_serve(dev, card, cfg, model, proc)
    check_serve_launches(serve_counts, forwards)
    for e in entries:  # each kernel's launches on its own path: run_batch for H1-H3, serving for H4-H6
        e["launches"] = counts[e["name"]] if e["name"] in counts else serve_counts[e["name"]]
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
