"""Device times of H1 (`rope_qk`) and H3 (`window_slot_attn`) at the main
paths' shapes, for one checkout of the port or another.

    python3 padt_tpu_torch/tools/rope_window_times.py [--root DIR] [--sweep]

`--root` imports `padt_tpu_torch` from DIR (default: this checkout), so
one call on the card can time an older tree (unpacked with `git archive`
into a directory that .gitignore lists) beside this one, in turns: the
wrappers' signatures without `plan=` are all it uses. Each shape's inputs
are made from a seed; each time is the mean of many calls queued behind a
spin of the GPU (device time, as chip_smoke's `cuda_ms`), the rope shapes
over q/k as the paths give them (views of the fused qkv where the path has
one). `--sweep` (this checkout's plans only) also times every candidate
launch plan: H1 at 1 and 2 heads a thread and blocks of 16-256, H3 at
66-132 CTAs with rings of 2, 4 and 6 stages, all under programmatic
dependent launch (PDL), and H1 / H3 (at 132 CTAs) without it. Prints one line per shape and one JSON line last.
Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean device ms per call of `iters` calls queued behind a ~20 ms spin."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def rope_cases(dev, g):
    """(label, q, k, cos, sin, hq, hk, sin_sign) at each shape the paths give H1."""
    import torch

    from padt_tpu_torch.models.vision_geom import vision_geometry
    from padt_tpu_torch.ops.rope import mrope_cos_sin, vision_rope_cos_sin

    rnd = lambda *shape: (torch.randn(shape, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    cases = []
    for b, tag in ((2, "vision 2x2304"), (8, "train tower 8x2304")):
        geo = vision_geometry([(1, 46, 46)] * b, 2304)
        cos, sin = vision_rope_cos_sin(torch.as_tensor(geo.hpos, device=dev), torch.as_tensor(geo.wpos, device=dev), 80)
        qkv = rnd(b, 2304, 3 * 16 * 80)
        cases.append((f"{tag}, (16+16)x80, views of the fused qkv", qkv[..., :1280], qkv[..., 1280:2560], cos, sin, 16, 16, 1.0))

    def text(b, l, h, hkv, fused, sign, tag, base=640):
        pos = (torch.arange(l, device=dev) + (base if l == 1 else 0))[None].expand(b, l)
        cos, sin = mrope_cos_sin(pos[None].expand(3, b, l), 128, (16, 24, 24))
        if fused:  # the packed weights' qkv: q and k are column views
            qkv = rnd(b, l, (h + 2 * hkv) * 128)
            q, k = qkv[..., : h * 128], qkv[..., h * 128 : (h + hkv) * 128]
        else:
            q, k = rnd(b, l, h * 128), rnd(b, l, hkv * 128)
        return (f"{tag} {b}x{l}, ({h}+{hkv})x128" + (", views of the fused qkv" if fused else "")
                + (", sin negated" if sign < 0 else ""), q, k, cos, sin, h, hkv, sign)

    cases += [
        text(2, 640, 16, 2, False, 1.0, "3B text"),
        text(4, 640, 28, 4, True, 1.0, "7B text"),
        text(8, 704, 16, 2, False, -1.0, "train VJP"),
        text(8, 1, 16, 2, True, 1.0, "3B serve decode"),
        text(4, 1, 16, 2, False, 1.0, "3B run_batch decode"),
        text(8, 1, 28, 4, True, 1.0, "7B decode"),
    ]
    return cases


def window_cases(dev, g):
    """(label, q, k, v, seg) of H3 at the tower's shapes, q/k contiguous (the
    rope's outputs), v a view of the fused qkv."""
    import torch

    from padt_tpu_torch.models.vision_geom import vision_geometry

    rnd = lambda *shape: (torch.randn(shape, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    cases = []
    for b, tag in ((2, "vision 2x2304"), (8, "train tower 8x2304")):
        geo = vision_geometry([(1, 46, 46)] * b, 2304)
        seg = torch.as_tensor(geo.seg_win, device=dev)
        qkv = rnd(b, 2304, 3 * 1280)
        q, k = rnd(b, 2304, 16, 80), rnd(b, 2304, 16, 80)
        cases.append((f"{tag}, 16x80, 36 slots", q, k, qkv[..., 2560:].unflatten(-1, (16, 80)), seg))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="import padt_tpu_torch from this directory")
    ap.add_argument("--sweep", action="store_true", help="also time every candidate launch plan")
    args = ap.parse_args()
    root = os.path.abspath(args.root or os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("rope_window_times: needs an NVIDIA GPU")
    import padt_tpu_torch  # noqa: F401  (from `root`)
    from padt_tpu_torch.ops import cuda_attention as C

    dev = torch.device("cuda", 0)
    card = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    where = os.path.relpath(os.path.dirname(padt_tpu_torch.__file__), os.getcwd())
    results = {"root": where, "card": card, "rope_qk": {}, "window_slot_attn": {}}
    for label, q, k, cos, sin, hq, hk, sign in rope_cases(dev, g):
        iters = 200 if q.shape[1] == 1 else 50
        ms = cuda_ms(lambda: C.rope_qk(q, k, cos, sin, hq, hk, sin_sign=sign), iters)
        bound = (2 * _nbytes(q, k) + _nbytes(cos, sin)) / HBM_BYTES_PER_S * 1e3
        results["rope_qk"][label] = ms
        print(f"[times] {where}: H1 {label}: {ms:.4f} ms, bound {bound:.4f} ms ({bound / ms:.3f} of it) ({card})", flush=True)
        if args.sweep:
            rows, heads, hd = q.shape[0] * q.shape[1], hq + hk, cos.shape[-1]
            for hpt, pdl in ((1, True), (2, True), (1, False), (2, False)):
                line = []
                for block in (16, 32, 64, 128, 256):
                    plan = C.rope_plan(rows, heads, hd, hpt=hpt, block=block, pdl=pdl)
                    t = cuda_ms(lambda: C.rope_qk(q, k, cos, sin, hq, hk, sin_sign=sign, plan=plan), iters)
                    line.append(f"block {block} {t:.4f}")
                print(f"[sweep] H1 {label}: hpt {hpt}{'' if pdl else ', no PDL'}: " + ", ".join(line)
                      + f" (default {C.rope_plan(rows, heads, hd)})", flush=True)
    for label, q, k, v, seg in window_cases(dev, g):
        ms = cuda_ms(lambda: C.window_slot_attn(q, k, v, seg, 80**-0.5), 50)
        bound = (4 * _nbytes(q) + _nbytes(seg)) / HBM_BYTES_PER_S * 1e3
        results["window_slot_attn"][label] = ms
        print(f"[times] {where}: H3 {label}: {ms:.4f} ms, bound {bound:.4f} ms ({bound / ms:.3f} of it) ({card})", flush=True)
        if args.sweep:
            b, s, h, hd = q.shape
            for ctas, pdl in ((66, True), (88, True), (110, True), (132, True), (132, False)):
                line = []
                for stages in (2, 4, 6):
                    plan = C.window_plan(b, s, h, hd, ctas=ctas, stages=stages, pdl=pdl)
                    if plan.smem <= C.SMEM_LIMIT:
                        t = cuda_ms(lambda: C.window_slot_attn(q, k, v, seg, 80**-0.5, plan=plan), 50)
                        line.append(f"{stages} stages {t:.4f}")
                print(f"[sweep] H3 {label}: {ctas} CTAs{'' if pdl else ', no PDL'}: " + ", ".join(line)
                      + f" (default {C.window_plan(b, s, h, hd)})", flush=True)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
