"""Times H10 (`stream_matmul`) and H7 (`int8_matmul`) under each candidate
launch plan at the shapes the main paths give them, so that
`ops.cuda_matmul.gemm_plan`'s choices rest on the card's own times.

    python3 -m padt_tpu_torch.tools.gemm_sweep [--only h10|h7] [--iters 10]

Shapes: PaDT-3B's four decode products at M = 96 through H10 (qkv and
gate-up also with the norm fused), PaDT-7B's four products at M = 8 and
2560 through H7. Candidates: K splits 1-8 (1-4 at prefill) and every stage
count that fits, each
checked against the plain twin on one layer (2e-2 of the largest output)
before it is timed. Each call walks the layers' weights as chip_smoke does,
so every call streams its weight from HBM. First it times each kernel with
one stage of K (its fixed cost). Prints one line per candidate and one JSON
line per shape: the default plan's time and the fastest
candidate's, with the card's name and power limit. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess

import torch

from ..config import padt_3b, padt_7b
from ..ops import cuda_matmul as CM
from ..ops import cuda_quant as Q
from ..ops import matmul as MM
from ..ops import quant
from .micro_stream_matmul import make_layers

WALK_BYTES = 150e6  # weight bytes a walk cycles through: three times the 50 MB L2


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


def candidates(m, n, k, int8):
    """Every plan gemm_plan can be told to take at this shape that fits."""
    swap = m <= CM.DECODE_M
    k_tiles = -(-k // CM.BK)
    out = []
    for splits in range(1, min(CM.MAX_CLUSTER if swap else 4, k_tiles) + 1):
        for stages in range(2, CM.MAX_STAGES + 1):
            p = CM.gemm_plan(m, n, k, int8, splits=splits, stages=stages)
            if p.smem <= CM.SMEM_LIMIT and stages <= max(2, -(-k_tiles // splits)):
                out.append(p)
    return out


def _sweep(tag, m, k, n, int8, run, plain, iters, card):
    default = CM.gemm_plan(m, n, k, int8)
    ref = plain().float()
    tol = 2e-2 * ref.abs().max().item()
    times = []
    for p in candidates(m, n, k, int8):
        err = (run(p, 0)().float() - ref).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"[sweep] {tag}: plan {p} is off its twin by {err} > {tol}")
        ms = _ms(run(p, None), iters)
        times.append((ms, p))
        print(f"[sweep] {tag} splits {p.splits} stages {p.stages} "
              f"({p.ctas} CTAs, {p.smem} B): {ms:.4f} ms", flush=True)
    best_ms, best = min(times, key=lambda t: t[0])
    default_ms = next(ms for ms, p in times if p == default)
    print(json.dumps({"shape": tag, "default": [default.splits, default.stages],
                      "default_ms": default_ms, "best": [best.splits, best.stages],
                      "best_ms": best_ms, "card": card}), flush=True)


def fixed_cost(dev, card, iters):
    """Each kernel's cost with next to no K (one stage of 64 rows, the weight
    in L2) at its decode shape: launch, prologue, the fold and the stores."""
    g = torch.Generator(device=dev).manual_seed(1)
    x = (torch.randn((96, 64), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    w = (torch.randn((1, 64, 2560), generator=g, device=dev) * 0.1).to(torch.bfloat16)
    xq = x[:8].contiguous()
    wq = torch.randint(-127, 128, (64, 4608), generator=g, device=dev, dtype=torch.int8)
    s = torch.full((4608,), 1e-3, device=dev)
    for tag, fn in (("H10 M=96 K=64 N=2560", lambda: CM.stream_matmul(x, w, 0)),
                    ("H7 M=8 K=64 N=4608", lambda: Q.int8_matmul(xq, wq, s))):
        print(f"[sweep] fixed cost, {tag} (one stage, one split): {_ms(fn, iters):.4f} ms ({card})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("h10", "h7"))
    ap.add_argument("--iters", type=int, default=10)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gemm_sweep: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    g = torch.Generator(device=dev).manual_seed(0)
    fixed_cost(dev, card, a.iters)
    if a.only in (None, "h10"):
        tcfg = padt_3b().text
        layers = make_layers(tcfg, dev)
        nl = tcfg.num_hidden_layers
        for name, ln_name, bias_name in (("qkv_w", "input_ln_w", "qkv_b"), ("o_w", None, None),
                                         ("gateup_w", "post_ln_w", None), ("down_w", None, None)):
            w = layers[name]
            _, k, n = w.shape
            x = (torch.randn((96, k), generator=g, device=dev) * 0.5).to(torch.bfloat16)
            for ln in (None, layers[ln_name]) if ln_name else (None,):
                bias = layers[bias_name] if bias_name else None

                def run(p, li, w=w, x=x, ln=ln, bias=bias):
                    it = itertools.cycle(range(nl)).__next__
                    return lambda: CM.stream_matmul(x, w, it() if li is None else li, ln, bias, tcfg.rms_norm_eps, plan=p)

                plain = lambda w=w, x=x, ln=ln, bias=bias: MM.stream_matmul_stacked_ref(x, w, 0, ln, bias, tcfg.rms_norm_eps)
                tag = f"H10 {name} M=96 K={k} N={n}{' fused' if ln is not None else ''}"
                _sweep(tag, 96, k, n, False, run, plain, a.iters, card)
        del layers
        torch.cuda.empty_cache()
    if a.only in (None, "h7"):
        t7 = padt_7b().text
        h, hd = t7.hidden_size, t7.head_dim
        shapes = (("qkv", h, (t7.num_attention_heads + 2 * t7.num_key_value_heads) * hd),
                  ("o", t7.num_attention_heads * hd, h), ("gate-up", h, 2 * t7.intermediate_size),
                  ("down", t7.intermediate_size, h))
        for name, k, n in shapes:
            nb = max(2, -(-int(WALK_BYTES) // (k * n)))
            wq = torch.randint(-127, 128, (nb, k, n), generator=g, device=dev, dtype=torch.int8)
            s = torch.exp(torch.randn((nb, n), generator=g, device=dev) * 0.3) * (2.0 / (73 * k**0.5))
            for m in (8, 2560):
                x = (torch.randn((m, k), generator=g, device=dev) * 0.5).to(torch.bfloat16)

                def run(p, li, x=x, wq=wq, s=s):
                    it = itertools.cycle(range(len(wq))).__next__

                    def call():
                        i = it() if li is None else li
                        return Q.int8_matmul(x, wq[i], s[i], plan=p)

                    return call

                plain = lambda x=x, wq=wq, s=s: quant.int8_matmul_plain(x, wq[0], s[0])
                _sweep(f"H7 {name} M={m} K={k} N={n}", m, k, n, True, run, plain, a.iters, card)
            del wq, s
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
