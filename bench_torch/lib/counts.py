"""Operations and bytes of the work a window did, from the cell's shapes
and the window's counts, never from a function of the program.

Counted is what the inputs need, not what buckets pad to: a query's real
patches and real prompt tokens, causal text attention, tower attention per
112 px window in the windowed blocks and over the image in the full ones.
A product of an (m, k) activation with a (k, n) weight is 2*m*k*n
operations. Peaks are NVIDIA's data sheet for one H100 SXM (dense, no
sparsity): 989 TFLOP/s in bf16 (H7 converts int8 weights to bf16 for the
tensor cores, so its peak is that too) and 3.35 TB/s of HBM3.
(The arithmetic follows `padt_tpu_torch/tools/profile_train.py::flops_per_step`
and `chip_smoke.py`'s peak constants, made causal and per real token.)
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from . import layout

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def text_layer_weights(model: Dict) -> Dict[str, Tuple[int, int]]:
    """(in, out) of each product of one text layer of Qwen2.5-VL's dense
    stack (`layouts/qwen25vl.py`)."""
    d, ff, hd = model["hidden_size"], model["intermediate_size"], model["head_dim"]
    qd, kvd = model["num_attention_heads"] * hd, model["num_key_value_heads"] * hd
    return {"qkv": (d, qd + 2 * kvd), "o": (qd, d), "gateup": (d, 2 * ff), "down": (ff, d)}


def text_layer_params(model: Dict) -> int:
    return sum(k * n for k, n in text_layer_weights(model).values())


def vision_params(model: Dict) -> int:
    vc = model["vision_config"]
    d, ff = vc["hidden_size"], vc["intermediate_size"]
    block = d * 3 * d + d * d + 3 * d * ff
    merged = d * vc["spatial_merge_size"] ** 2
    patch_in = vc["in_chans"] * vc["temporal_patch_size"] * vc["patch_size"] ** 2
    return vc["depth"] * block + patch_in * d + merged * merged + merged * vc["out_hidden_size"]


def window_sizes(grid: Sequence[int], model: Dict) -> Tuple[int, ...]:
    """Patches in each 112 px window of an image of `grid` patches."""
    vc = model["vision_config"]
    _, gh, gw = (int(v) for v in grid)
    m = vc["spatial_merge_size"]
    units = vc["window_size"] // (vc["patch_size"] * m)  # merged units per window side
    mh, mw = gh // m, gw // m
    rows = [min(units, mh - r) for r in range(0, mh, units)]
    cols = [min(units, mw - c) for c in range(0, mw, units)]
    return tuple(r * c * m * m for r in rows for c in cols)


def vision_flops(grid: Sequence[int], model: Dict) -> float:
    vc = model["vision_config"]
    s = int(grid[0]) * int(grid[1]) * int(grid[2])
    n_full = len(vc["fullatt_block_indexes"])
    d = vc["hidden_size"]
    win = sum(w * w for w in window_sizes(grid, model))
    attn = 4 * d * (n_full * s * s + (vc["depth"] - n_full) * win)
    return 2.0 * vision_params(model) * s + attn


def head_width(model: Dict, n_merged: int) -> int:
    return model["vocab_size"] + n_merged


def query_flops(model: Dict, grid: Sequence[int], prompt_tokens: int, generated: int) -> float:
    """One served query: the tower over its real patches, the prototype
    projection, the text layers' work (the configuration's layout's
    `text_flops`: prefill and decode), and the logits of each generated
    token over the vocabulary and the image's VRT rows."""
    d = model["hidden_size"]
    n_merged = int(grid[0]) * int(grid[1]) * int(grid[2]) // model["vision_config"]["spatial_merge_size"] ** 2
    proto = 2.0 * n_merged * 2 * d * model["prototype_proj_rank"]
    text = layout.text_layout(model).text_flops(model, prompt_tokens, generated)
    logits = 2.0 * d * head_width(model, n_merged) * generated
    return vision_flops(grid, model) + proto + text + logits


def int8_product_work(model: Dict, rows: float, forwards: int) -> Tuple[float, float]:
    """(operations, bytes) of the int8-weight text products of `forwards`
    forward passes that together carry `rows` activation rows: each pass
    reads every int8 weight and its float32 column scales once, and every
    row's bf16 input and output once."""
    nl = model["num_hidden_layers"]
    ops = 0.0
    nbytes = 0.0
    for k, n in text_layer_weights(model).values():
        ops += 2.0 * rows * k * n * nl
        nbytes += forwards * nl * (k * n + 4 * n) + rows * nl * 2 * (k + n)
    return ops, nbytes


def least_seconds(ops: float, nbytes: float, peak_flops: float = BF16_FLOPS) -> float:
    return max(ops / peak_flops, nbytes / HBM_BYTES_PER_S)
