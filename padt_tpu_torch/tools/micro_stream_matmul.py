"""The decode weight stream, matmuls only: `torch.matmul` against the H10
streaming matmul (`ops.matmul.stream_matmul_stacked`) on the decode layer
loop of PaDT-3B at B = 96.

    python3 -m padt_tpu_torch.tools.micro_stream_matmul [--b 96] [--reps 20]
    python3 -m padt_tpu_torch.tools.micro_stream_matmul --tiny   # padt_tiny on the CPU

The loop runs every text layer over the packed serving layout
(`pack_inference_params`'s `qkv_w`, `qkv_b`, `o_w`, `gateup_w`, `down_w`
and both norms; random bf16 weights from a seed) with rope, the SiLU gate
and the residuals, attention replaced by a pass-through that keeps the k/v
columns live. Three variants:

  torch        rms_norm, then x @ w[li] (the production bf16 product)
  stream       H10 with the norms fused into the qkv and gate-up products
  stream_noln  H10 on the products, the norms left to rms_norm

It prints one JSON line: per variant the device ms per pass over all the
layers (the pass captured once in a CUDA graph and replayed `--reps` times
between CUDA events, so host overhead is left out) and GB/s over the weight
bytes; H10's launches per pass; the largest gap of each stream variant's
output from the torch variant's, and that output's largest magnitude; each
variant's largest gap from the same loop in float32 (the torch variant on
float32 copies of the weights: the yardstick of bf16 rounding over the
layers); the card's name and power limit. With --tiny it runs on the CPU
through the plain versions and prints the gaps only (no time is measured
there).
This is the port's entry point of K19 (`scripts/micro_stream_matmul.py`).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from ..config import padt_3b, padt_tiny
from ..ops import cuda_matmul
from ..ops.matmul import stream_matmul_stacked
from ..ops.norms import rms_norm
from ..ops.rope import apply_rotary, mrope_cos_sin

VARIANTS = ("torch", "stream", "stream_noln")
POSITION = 900  # every row's rope position (a decode step deep into a 640-token prompt)


def make_layers(tcfg, device, seed: int = 0):
    """The packed text layers, random bf16 from a seed (drawn on `device`):
    norms near 1, weights of scale 0.02, a qkv bias of scale 0.02."""
    g = torch.Generator(device=device).manual_seed(seed)
    nl, d, ff = tcfg.num_hidden_layers, tcfg.hidden_size, tcfg.intermediate_size
    h, hkv, hd = tcfg.num_attention_heads, tcfg.num_key_value_heads, tcfg.head_dim

    def rnd(*shape, scale=0.02, mean=0.0):
        return (torch.randn((nl, *shape), generator=g, device=device) * scale + mean).to(torch.bfloat16)

    return {
        "input_ln_w": rnd(d, scale=0.1, mean=1.0),
        "post_ln_w": rnd(d, scale=0.1, mean=1.0),
        "qkv_w": rnd(d, (h + 2 * hkv) * hd),
        "qkv_b": rnd((h + 2 * hkv) * hd),
        "o_w": rnd(h * hd, d),
        "gateup_w": rnd(d, 2 * ff),
        "down_w": rnd(ff, d),
    }


def layer_loop(variant: str, x, p, cos, sin, tcfg):
    """One pass over every layer: x (B, d) bf16 -> (B, d)."""
    b = x.shape[0]
    h, hkv, hd, ff, eps = (tcfg.num_attention_heads, tcfg.num_key_value_heads, tcfg.head_dim,
                           tcfg.intermediate_size, tcfg.rms_norm_eps)

    def attend(qkv):  # rope on q and k; k + v folded into q so their columns stay live
        q = apply_rotary(qkv[:, : h * hd].reshape(b, h, hd), cos, sin)
        k = apply_rotary(qkv[:, h * hd : (h + hkv) * hd].reshape(b, hkv, hd), cos, sin)
        v = qkv[:, (h + hkv) * hd :].reshape(b, hkv, hd)
        return (q + F.pad(k + v, (0, 0, 0, h - hkv))).reshape(b, h * hd)

    for li in range(tcfg.num_hidden_layers):
        if variant == "torch":
            qkv = rms_norm(x, p["input_ln_w"][li], eps) @ p["qkv_w"][li] + p["qkv_b"][li]
            x = x + attend(qkv) @ p["o_w"][li]
            gu = rms_norm(x, p["post_ln_w"][li], eps) @ p["gateup_w"][li]
            x = x + (F.silu(gu[:, :ff]) * gu[:, ff:]) @ p["down_w"][li]
        elif variant == "stream":
            qkv = stream_matmul_stacked(x, p["qkv_w"], li, ln_w=p["input_ln_w"], bias=p["qkv_b"], eps=eps)
            x = x + stream_matmul_stacked(attend(qkv), p["o_w"], li)
            gu = stream_matmul_stacked(x, p["gateup_w"], li, ln_w=p["post_ln_w"], eps=eps)
            x = x + stream_matmul_stacked(F.silu(gu[:, :ff]) * gu[:, ff:], p["down_w"], li)
        elif variant == "stream_noln":
            qkv = stream_matmul_stacked(rms_norm(x, p["input_ln_w"][li], eps), p["qkv_w"], li, bias=p["qkv_b"])
            x = x + stream_matmul_stacked(attend(qkv), p["o_w"], li)
            gu = stream_matmul_stacked(rms_norm(x, p["post_ln_w"][li], eps), p["gateup_w"], li)
            x = x + stream_matmul_stacked(F.silu(gu[:, :ff]) * gu[:, ff:], p["down_w"], li)
        else:
            raise ValueError(f"unknown variant {variant!r}")
    return x


def graph_ms(fn, reps: int) -> float:
    """Device ms per call of `fn`: captured once in a CUDA graph, replayed
    `reps` times between CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def run(tcfg, b: int, device, reps: int = 20, seed: int = 0, timed: bool = True, layers=None):
    """(results dict, {variant: output (B, d)}) over `layers` (by default
    make_layers(tcfg, device, seed)). `timed` needs CUDA."""
    p = make_layers(tcfg, device, seed) if layers is None else layers
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    x = (torch.randn((b, tcfg.hidden_size), generator=g) * 0.1).to(device=device, dtype=torch.bfloat16)
    pos = torch.full((3, b, 1), POSITION, dtype=torch.int64, device=device)
    cos, sin = mrope_cos_sin(pos, tcfg.head_dim, tcfg.mrope_section, tcfg.rope_theta)  # (B, 1, hd)
    wbytes = sum(t.numel() * t.element_size() for t in p.values())
    res = {"b": b, "layers": tcfg.num_hidden_layers, "weight_bytes": wbytes}
    outs = {}
    with torch.inference_mode():
        for name in VARIANTS:
            n0 = cuda_matmul.launch_counts["stream_matmul"]
            outs[name] = layer_loop(name, x, p, cos, sin, tcfg)
            res[f"{name}_launches"] = cuda_matmul.launch_counts["stream_matmul"] - n0
        ref = outs["torch"].float()
        res["max_abs_torch"] = ref.abs().max().item()
        for name in VARIANTS[1:]:
            res[f"max_gap_{name}"] = (outs[name].float() - ref).abs().max().item()
        f32 = layer_loop("torch", x.float(), {k: v.float() for k, v in p.items()}, cos, sin, tcfg)
        for name in VARIANTS:
            res[f"gap_f32_{name}"] = (outs[name].float() - f32).abs().max().item()
        if timed:
            for name in VARIANTS:
                ms = graph_ms(lambda: layer_loop(name, x, p, cos, sin, tcfg), reps)
                res[f"{name}_ms"] = ms
                res[f"{name}_gbps"] = wbytes / (ms / 1e3) / 1e9
    return res, outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=96, help="decode rows (slots)")
    ap.add_argument("--reps", type=int, default=20, help="graph replays timed per variant")
    ap.add_argument("--tiny", action="store_true", help="padt_tiny on the CPU, gaps only")
    args = ap.parse_args(argv)
    if args.tiny:
        res, _ = run(padt_tiny().text, args.b, "cpu", timed=False)
        res["device"] = "cpu (plain versions; no time measured)"
    else:
        if not torch.cuda.is_available():
            raise SystemExit("micro_stream_matmul: needs CUDA (or --tiny for the CPU check)")
        res, _ = run(padt_3b().text, args.b, torch.device("cuda", 0), args.reps)
        res["device"] = card()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
