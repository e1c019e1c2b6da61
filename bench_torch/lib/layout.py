"""The weights a cell serves, made from `--seed` on the device.

The tree has the keys, shapes and dtypes of the program's parameter tree
(its checkpoint layout: stacked `(layers, in, out)` text and tower weights
applied as `x @ w`). The values are the benchmark's own: the program
receives the tree as a checkpoint, and the reference reads the same
tensors. This file spells out what every PaDT configuration shares: the
tower, the PaDT decoder and the prototype projection. The text stack's
subtree is its layout's: `layouts/<layout>.py`, named by the
configuration's `layout` key.

Leaves are views into one buffer per dtype, filled by a few large calls of
a `torch.Generator` on the device: matrices and biases N(0, std), norm
weights 1, the prototype LayerNorm's weight and bias 0 (PaDT's init),
int8 values uniform in [-127, 127] with scales std / 73 times U(0.5, 1.5)
per column (73 is the standard deviation of the uniform int8 values, so
the dequantized weights have the dense weights' spread). std is the
configuration's `init_std`, 0.02 where it names none (the CPU tests' tiny
configuration takes 0.1, so that its layers' outputs weigh against the
embeddings as they do at the published widths).
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, List, Tuple

import torch

FILL_CHUNK = 1 << 28  # elements per generator call


def _lin(din: int, dout: int, bias: bool = True) -> Dict:
    out = {"w": ((din, dout), "w")}
    if bias:
        out["b"] = ((dout,), "b")
    return out


def _decoder(dc: Dict, llm_hidden: int) -> Dict:
    d, ff = dc["hidden_size"], dc["intermediate_size"]
    attn = lambda: {n: _lin(d, d) for n in ("q", "k", "v", "o")}

    def block():
        out = {f"norm{i}_w": ((d,), "one") for i in range(1, 7)}
        out.update(self_attn=attn(), cross_q2i=attn(), cross_i2q=attn(), mlp_fc1=_lin(d, ff), mlp_fc2=_lin(ff, d))
        return out

    return {
        "vp_embedding": ((d,), "w"),
        "bbox_score_mask_tokens": ((3, d), "w"),
        "input_proj": {"norm_w": ((llm_hidden,), "one"), "fc1": _lin(llm_hidden, d), "fc2": _lin(d, d)},
        "low_res": block(), "high_res1": block(), "high_res2": block(),
        "high_res_norm_w": ((d,), "one"),
        "bbox_fc1": _lin(d, d), "bbox_fc2": _lin(d, d), "bbox_fc3": _lin(d, 4),
        "score": _lin(d, 1),
        "mask_up1": {**_lin(d, d // 4 * 4), "norm_w": ((d // 4 * 4,), "one")},
        "mask_up2": _lin(d // 4, d // 16 * 4),
        "mask_mlp_fc1": _lin(d, d), "mask_mlp_fc2": _lin(d, d), "mask_mlp_fc3": _lin(d, d // 16),
    }


def text_layout(model: Dict):
    """The module of `layouts/` that the configuration's `layout` key names
    (`qwen25vl` where it names none): its text stack's `text_spec` and
    `text_flops`."""
    name = model.get("layout", "qwen25vl")
    try:
        return importlib.import_module(f"bench_torch.layouts.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"bench_torch.layouts.{name}":
            raise
        raise SystemExit(f"unknown layout {name!r}: there is no bench_torch/layouts/{name}.py") from None


def spec(model: Dict) -> Dict:
    """The tree's leaves as (shape, kind); kind is w, b, one, zero, q8 or s8."""
    vc, dc = model["vision_config"], model["decoder_config"]
    d = model["hidden_size"]
    vd, vff, depth = vc["hidden_size"], vc["intermediate_size"], vc["depth"]
    patch_in = vc["in_chans"] * vc["temporal_patch_size"] * vc["patch_size"] ** 2
    merged = vd * vc["spatial_merge_size"] ** 2
    blocks = {"norm1_w": ((depth, vd), "one"), "norm2_w": ((depth, vd), "one")}
    for name, (din, dout) in {"qkv": (vd, 3 * vd), "proj": (vd, vd), "gate": (vd, vff), "up": (vd, vff), "down": (vff, vd)}.items():
        blocks[name + "_w"] = ((depth, din, dout), "w")
        blocks[name + "_b"] = ((depth, dout), "b")
    vision = {
        "patch_embed": {"w": ((patch_in, vd), "w")},
        "blocks": blocks,
        "merger": {"ln_q_w": ((vd,), "one"), "fc1": _lin(merged, merged), "fc2": _lin(merged, vc["out_hidden_size"])},
    }
    r = model["prototype_proj_rank"]
    # PaDT's ZeroInitLayerNorm: the prototypes, and so every VRT logit, are 0
    # until training moves them, so random weights never serve a VRT token
    # and every seed's queries do the same work after the last text token
    proto = {"ln_w": ((d,), "zero"), "ln_b": ((d,), "zero"), "down_w": ((d, r), "w"), "up_w": ((r, d), "w")}
    return {"vision": vision, "text": text_layout(model).text_spec(model), "decoder": _decoder(dc, d), "proto": proto}


def _leaves(tree, prefix=()) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v[0], v[1]))
    return out


_DTYPE = {"w": torch.bfloat16, "b": torch.bfloat16, "one": torch.bfloat16, "zero": torch.bfloat16, "q8": torch.int8,
          "s8": torch.float32}


def make_weights(model: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The seeded tree on `device`; bfloat16 leaves in `dtype`."""
    leaves = _leaves(spec(model))
    g = torch.Generator(device=device).manual_seed(seed)
    std = model.get("init_std", 0.02)
    dtypes = dict(_DTYPE, w=dtype, b=dtype, one=dtype, zero=dtype)
    tree: Dict = {}
    for kinds in (("w", "b"), ("one",), ("zero",), ("q8",), ("s8",)):
        group = [leaf for leaf in leaves if leaf[2] in kinds]
        if not group:
            continue
        total = sum(math.prod(shape) for _, shape, _ in group)
        buf = torch.empty(total, dtype=dtypes[kinds[0]], device=device)
        for start in range(0, total, FILL_CHUNK):
            part = buf[start : start + FILL_CHUNK]
            if kinds[0] == "w":
                part.normal_(0.0, std, generator=g)
            elif kinds[0] in ("one", "zero"):
                part.fill_(1.0 if kinds[0] == "one" else 0.0)
            elif kinds[0] == "q8":
                part.random_(-127, 128, generator=g)
            else:
                part.uniform_(0.5 * std / 73.0, 1.5 * std / 73.0, generator=g)
        at = 0
        for path, shape, _ in group:
            n = math.prod(shape)
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = buf[at : at + n].view(shape)
            at += n
    return tree
