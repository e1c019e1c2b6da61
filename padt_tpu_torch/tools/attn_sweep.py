"""Times H4 (`int8_decode_attn`) and H5 (`int8_verify_attn`) under each
candidate launch plan at the shapes the main paths give them, so that
`ops.cuda_kv.attn_plan`'s choices rest on the card's own times.

    python3 -m padt_tpu_torch.tools.attn_sweep [--only h4|h5] [--iters 36]

Shapes (PaDT-3B's 2 kv heads of 128 over a 36-layer int8 cache of
capacity 768, 16 slots, ~600 live rows; PaDT-7B's 4 kv heads over 28
layers, 8 slots): H4 at decode with its fresh column, in QI8 mode and at
7B; H5 at the suffix pass (kq = 32 fresh columns) and at speculative
verify (kq = 4). Candidates: column splits 1-8 and 2, 3 or a resident
ring's stage count (and H5 with one or two 64-row tiles a CTA), each
checked against the plain twin on one layer (2e-2
of the largest output) before it is timed. Each call walks the layers as
chip_smoke does, so every call reads its layer from HBM. First it times H4
over no column at all (n_valid = 0: launch, prologue, cluster exchange and
fold only) at each split. Prints one line per candidate and one JSON line
per shape: the default plan's time and the fastest candidate's, with the
card's name and power limit. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess

import torch

from ..config import padt_3b, padt_7b
from ..ops import cuda_kv as K


def _ms(fn, iters):
    """Device ms per call between CUDA events, the host queued ahead."""
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


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def _inputs(dev, nl, b, hkv, c, hd, kq, g, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    i8 = lambda *s: torch.randint(-127, 128, s, generator=gen, device=dev, dtype=torch.int8)
    sc = lambda *s: torch.exp(torch.randn(s, generator=gen, device=dev) * 0.4 - 4.0)
    kv = lambda *lead: (i8(*lead, hd), sc(*lead), i8(*lead, hd), sc(*lead))
    lens = torch.randint(540, c - 32, (b,), generator=gen, device=dev)
    cols = torch.arange(c, device=dev)[None]
    valid = (cols < lens[:, None]) & (cols >= 40)
    q = (torch.randn((b, hkv, g * kq, hd), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    return kv(nl, b, hkv, c), kv(b, hkv, kq), valid, q


def candidates(kind, b, hkv, rows, c, hd, nf):
    out = []
    row_tiles = (1, 2) if kind == "verify" and hd <= 128 and rows > K.ATTN_ROWS[kind] else (1,)
    for split, rt in itertools.product((1, 2, 4, 8), row_tiles):
        chunk = -(-c // split)
        tiles = -(-chunk // K.ATTN_TILE) + (-(-nf // K.ATTN_TILE) if kind == "verify" else 0)
        for stages in sorted({2, 3, max(tiles, 2)}):
            p = K.attn_plan(kind, b, hkv, rows, c, hd, nf, split=split, stages=stages, row_tiles=rt)
            if p.smem <= K._SMEM_LIMIT:
                out.append(p)
    return out


def sweep(kind, label, dev, nl, b, hkv, c, hd, kq, g, iters, card, qi8=False):
    cache, fresh, valid, q = _inputs(dev, nl, b, hkv, c, hd, kq, g)
    nxt = itertools.cycle(range(nl)).__next__
    if kind == "decode":
        call = lambda layer, plan=None: K.int8_decode_attn(q, *cache, *fresh, valid, layer, quantize_q=qi8, plan=plan)
        plain = lambda: K.int8_decode_attn_plain(q, *cache, *fresh, valid, 0, quantize_q=qi8)
        default = K.attn_plan("decode", b, hkv, g, c, hd)
        nf, rows = 0, g
    else:
        call = lambda layer, plan=None: K.int8_verify_attn(q, *cache, *fresh, valid, layer, kq, plan=plan)
        plain = lambda: K.int8_verify_attn_plain(q, *cache, *fresh, valid, 0, kq)
        default = K.attn_plan("verify", b, hkv, g * kq, c, hd, kq)
        nf, rows = kq, g * kq
    ref = plain().float()
    top = ref.abs().max().item()
    times = {}
    for p in candidates(kind, b, hkv, rows, c, hd, nf):
        err = (call(0, p).float() - ref).abs().max().item()
        if not err <= 2e-2 * top:
            raise AssertionError(f"{label} split {p.split} stages {p.stages}: max abs err {err} > {2e-2 * top}")
        ms = _ms(lambda: call(nxt(), p), iters)
        key = (p.split, p.stages, p.row_tiles)
        times[key] = ms
        mark = " (default)" if key == (default.split, default.stages, default.row_tiles) else ""
        print(f"[attn_sweep] {label}: split {p.split}, stages {p.stages}, row tiles {p.row_tiles}, {p.ctas} CTAs, "
              f"{p.smem} B shared: {ms:.4f} ms{mark} ({card})", flush=True)
    best = min(times, key=times.get)
    dkey = (default.split, default.stages, default.row_tiles)
    print(json.dumps({"shape": label, "default": list(dkey), "default_ms": times[dkey], "best": list(best),
                      "best_ms": times[best], "card": card}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("h4", "h5"))
    ap.add_argument("--iters", type=int, default=36)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attn_sweep needs an NVIDIA GPU")
    dev, card = torch.device("cuda", 0), _card()
    c3, c7 = padt_3b().text, padt_7b().text
    nl3, h3, d3, g3 = c3.num_hidden_layers, c3.num_key_value_heads, c3.head_dim, c3.num_attention_heads // c3.num_key_value_heads
    nl7, h7, g7 = c7.num_hidden_layers, c7.num_key_value_heads, c7.num_attention_heads // c7.num_key_value_heads
    if args.only != "h5":
        cache, _, valid, q = _inputs(dev, nl3, 16, h3, 768, d3, 1, g3)
        nv = torch.zeros(16, dtype=torch.int32, device=dev)
        nxt = itertools.cycle(range(nl3)).__next__
        for split in (1, 2, 4, 8):
            p = K.attn_plan("decode", 16, h3, g3, 768, d3, split=split, stages=2)
            ms = _ms(lambda: K.int8_decode_attn(q, *cache, None, None, None, None, valid, nxt(), n_valid=nv, plan=p), args.iters)
            print(f"[attn_sweep] H4 over no column (n_valid 0), split {split}: {ms:.4f} ms ({card})", flush=True)
        del cache
        sweep("decode", "H4 decode 16 slots x 2 kv x 8 q", dev, nl3, 16, h3, 768, d3, 1, g3, args.iters, card)
        sweep("decode", "H4 QI8 decode 16 slots x 2 kv x 8 q", dev, nl3, 16, h3, 768, d3, 1, g3, args.iters, card, qi8=True)
        sweep("decode", "H4 7B decode 8 slots x 4 kv x 7 q", dev, nl7, 8, h7, 768, c7.head_dim, 1, g7, args.iters, card)
    if args.only != "h4":
        sweep("verify", "H5 suffix pass 16 slots x 2 kv x (8x32) q", dev, nl3, 16, h3, 768, d3, 32, g3, args.iters, card)
        sweep("verify", "H5 speculative verify 16 slots x 2 kv x (8x4) q", dev, nl3, 16, h3, 768, d3, 4, g3, args.iters, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
