"""Device times of H6 (`store_kv_rows`) at the main paths' shapes, for one
checkout of the port or another, and the host's cost of handing it the
decode path's new rows.

    python3 padt_tpu_torch/tools/store_rows_times.py [--root DIR] [--sweep]

`--root` imports `padt_tpu_torch` from DIR (default: this checkout), so one
call on the card can time an older tree (unpacked with `git archive` into a
directory that .gitignore lists) beside this one, in turns: the wrapper's
signature without `plan=` is all it uses. Shapes: the 3B decode store (36
layers x 16 slots x 2 kv heads, one row), the suffix store (up to 32 rows a
slot), PaDT-7B's decode store (28 x 8 x 4), and one layer of the 16-slot
pool at 1 and 32 rows (the single-layer forms); the calls walk copies of
the cache three times the L2, so each writes rows it finds in HBM. Each
time is the median of three means of 50 calls queued behind a spin of the
GPU (device time, as chip_smoke's `cuda_ms`). Beside it, the host's
microseconds per call of the path's form: at the all-layer shapes, every
layer's bf16 K and V rows quantized as that tree's `int8_layers` does
(into one stacked buffer here; one tensor a layer, then `torch.stack`, in
older trees), then the store; at the one-layer shapes, the store alone.
`--sweep` (this checkout only) also times every candidate launch plan
(rows a thread, block, with and without programmatic dependent launch).
Prints one line per shape and one JSON line last. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
L2_WALK_BYTES = 150e6  # three times the 50 MB L2


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=50, repeats=3):
    """Median over `repeats` of the mean device ms per call of `iters`
    calls queued behind a ~20 ms spin (the host queues them all before the
    device reaches them; a repeat whose host fell behind reads high, and the
    median drops it)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return sorted(times)[len(times) // 2]


def host_us(fn, iters=100, repeats=3):
    """Host microseconds per call, the median over `repeats` of the mean
    over `iters` calls (the device keeps up: each call's kernels take a few
    microseconds of device time)."""
    import time

    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / iters * 1e6)
    return sorted(times)[len(times) // 2]


def store_cases(dev, g):
    """(label, caches (a list of (k8, ks, v8, vs) copies to walk), new rows
    (stacked), pos, n_rows, each layer's bf16 (K, V) new rows (B, n, Hkv,
    hd) as the layers' projections give them) at each shape the paths give
    H6."""
    import torch

    i8 = lambda *s: torch.randint(-127, 128, s, generator=g, device=dev, dtype=torch.int8)
    sc = lambda *s: torch.exp(torch.randn(s, generator=g, device=dev) * 0.4 - 4.0)
    kv = lambda *lead: (i8(*lead, 128), sc(*lead), i8(*lead, 128), sc(*lead))
    cases = []
    for label, nl, b, hkv, kq in (("3B decode, 1 row", 36, 16, 2, 1), ("3B suffix, n_rows 0..32", 36, 16, 2, 32),
                                  ("7B decode, 1 row", 28, 8, 4, 1), ("one layer, 1 row", 1, 16, 2, 1),
                                  ("one layer, 32 rows", 1, 16, 2, 32)):
        cap = 768
        per_copy = 2 * nl * b * hkv * cap * (128 + 4)
        copies = max(2, -(-int(L2_WALK_BYTES) // per_copy))
        caches = [kv(nl, b, hkv, cap) for _ in range(copies)]
        pos = torch.randint(500, cap - 32, (b,), generator=g, device=dev, dtype=torch.int32)
        n_rows = (torch.randint(0, 33, (b,), generator=g, device=dev, dtype=torch.int32) if kq == 32 and nl > 1
                  else torch.full((b,), kq, dtype=torch.int32, device=dev))
        bf16 = lambda: torch.randn((b, kq, hkv, 128), generator=g, device=dev).to(torch.bfloat16)
        layers_kv = [(bf16(), bf16()) for _ in range(nl)]
        cases.append((f"{label} x {nl} layers x {b} slots x {hkv} kv heads", caches, kv(nl, b, hkv, kq), pos, n_rows,
                      layers_kv))
    return cases


def quantized_rows(TK, layers_kv):
    """Every layer's new rows as the tree's `int8_layers` hands them to H6:
    quantized into slices of one stacked buffer where `quantize_kv` takes
    `out=`, else quantized a layer at a time and stacked."""
    import inspect

    import torch

    if "out" not in inspect.signature(TK.quantize_kv).parameters:
        rows = [(*TK.quantize_kv(k.transpose(1, 2)), *TK.quantize_kv(v.transpose(1, 2))) for k, v in layers_kv]
        return tuple(torch.stack(t) for t in zip(*rows))
    nl, (b, n, hkv, hd) = len(layers_kv), layers_kv[0][0].shape
    dev = layers_kv[0][0].device
    i8 = lambda: torch.empty((nl, b, hkv, n, hd), dtype=torch.int8, device=dev)
    f32 = lambda: torch.empty((nl, b, hkv, n), dtype=torch.float32, device=dev)
    stacked = (i8(), f32(), i8(), f32())
    k8r, ksr, v8r, vsr = (t.unbind(0) for t in stacked)
    for li, (k, v) in enumerate(layers_kv):
        TK.quantize_kv(k.transpose(1, 2), out=(k8r[li], ksr[li]))
        TK.quantize_kv(v.transpose(1, 2), out=(v8r[li], vsr[li]))
    return stacked


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="import padt_tpu_torch from this directory")
    ap.add_argument("--sweep", action="store_true", help="also time every candidate launch plan")
    args = ap.parse_args()
    root = os.path.abspath(args.root or os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    import itertools

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("store_rows_times: needs an NVIDIA GPU")
    import padt_tpu_torch  # noqa: F401  (from `root`)
    from padt_tpu_torch.ops import cuda_kv as K

    dev = torch.device("cuda", 0)
    card = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    where = os.path.relpath(os.path.dirname(padt_tpu_torch.__file__), os.getcwd())
    results = {"root": where, "card": card, "store_kv_rows": {}}
    from padt_tpu_torch.ops import kv_cache as TK

    for label, caches, rows, pos, n_rows, layers_kv in store_cases(dev, g):
        nl, b, hkv, kq, hd = rows[0].shape
        walk = itertools.cycle(caches)
        run = lambda **kw: (lambda: K.store_kv_rows(*next(walk), *rows, pos, n_rows, **kw))
        ms = cuda_ms(run())
        n_written = int(n_rows.clamp(max=kq).sum())
        bound = 2 * n_written * nl * hkv * (2 * hd + 8) / HBM_BYTES_PER_S * 1e3  # each row read once, written once
        if nl > 1:  # the decode path: quantize every layer's rows as int8_layers does, then the store
            form = "quantize every layer's rows, then the store"
            path = lambda: K.store_kv_rows(*next(walk), *quantized_rows(TK, layers_kv), pos, n_rows)
        else:
            form, path = "the store", run()
        us = host_us(path)
        results["store_kv_rows"][label] = {"ms": ms, "host_us": us}
        print(f"[times] {where}: H6 {label}: {ms:.4f} ms, bound {bound:.5f} ms ({bound / ms:.3f} of it); host "
              f"{us:.1f} us a call of the path's form ({form}) ({card})", flush=True)
        if args.sweep:
            line = []
            for rpt in (r for r in K.STORE_RPTS if r <= kq):
                for pdl in (False, True):
                    for block in K.STORE_BLOCKS:
                        plan = K.store_plan(nl, b, hkv, kq, hd, rpt=rpt, block=block, pdl=pdl)
                        t = cuda_ms(run(plan=plan))
                        line.append(f"{rpt} rows a thread, block {block}{'' if pdl else ' no PDL'} {t:.4f}")
            print(f"[sweep] H6 {label}: " + ", ".join(line) + f" (default {K.store_plan(nl, b, hkv, kq, hd)})", flush=True)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
