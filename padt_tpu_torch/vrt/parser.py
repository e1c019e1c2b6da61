"""Host-side VRT completion parser (the port's copy of `padt_tpu/vrt/parser.py`).

Rebuilds `parseVRTintoCompletion` (reference `padt_processor.py:60-151`): a
token-stream state machine that extracts, per sample,
  - the completion string,
  - consecutive runs of `<|VRT_*|>` tokens (one run == one object),
  - each run's quoted "label" seen most recently before it,
  - optional `<answer>`-tag gating (thinking mode).

TPU-first divergence: the reference gathers each VRT's hidden state tensor
inside the parser (`padt_processor.py:125`, a per-token host/device
interaction); here the parser returns POSITIONS, and `pack_objects` performs
one batched device gather from the generation hidden buffer.

Per-sample malformed output degrades to an empty object list
(reference `padt_processor.py:146-150`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class ParsedObject:
    sample: int
    label: str
    vrt_string: str
    positions: List[int]  # token positions within the completion
    patch_ids: List[int]  # local merged-patch ids (token_id - vocab_size)


@dataclass
class ParseResult:
    completions: List[str]
    objects_per_sample: List[List[ParsedObject]]

    @property
    def all_objects(self) -> List[ParsedObject]:
        return [o for objs in self.objects_per_sample for o in objs]

    # reference-compatible views (parseVRTintoCompletion's ret_labels / ret_vrts)
    @property
    def labels_per_sample(self) -> List[List[str]]:
        return [[o.label for o in objs] for objs in self.objects_per_sample]

    @property
    def vrts_per_sample(self) -> List[List[str]]:
        return [[o.vrt_string for o in objs] for objs in self.objects_per_sample]


def parse_vrt_completions(
    token_strs: Sequence[Sequence[str]],  # per-sample, per-token decoded strings
    token_ids: np.ndarray,  # (B, T) int — completion ids (local VRT convention)
    vocab_size: int,
    eos_strings: Tuple[str, ...] = ("<|im_end|>", "<|endoftext|>"),
    need_thinking: Optional[Sequence[bool]] = None,
) -> ParseResult:
    completions: List[str] = []
    objects_all: List[List[ParsedObject]] = []
    b = len(token_strs)
    if need_thinking is None:
        need_thinking = [False] * b  # eval path passes all-False (utils.py:240)

    for i in range(b):
        toks = list(token_strs[i])
        ids = token_ids[i]
        completions.append("".join(toks))
        objs: List[ParsedObject] = []
        try:
            objs = _parse_one(toks, ids, vocab_size, eos_strings, not need_thinking[i], i)
        except Exception:
            objs = []  # malformed generation -> no objects (padt_processor.py:146-150)
        objects_all.append(objs)
    return ParseResult(completions=completions, objects_per_sample=objects_all)


def _parse_one(toks, ids, vocab_size, eos_strings, without_thinking, sample_idx):
    objs: List[ParsedObject] = []
    n = len(toks)
    j = 0
    within_answer = False
    within_label = False
    label = ""
    while j < n:
        tok = toks[j]
        if any(e in tok for e in eos_strings):
            break
        if (
            not within_answer
            and "<" in tok
            and "</" not in tok
            and j + 2 < n
            and "answer" in toks[j + 1]
            and ">" in toks[j + 2]
        ):
            within_answer = True
            j += 3
            continue
        if within_answer or without_thinking:
            if "</" in tok and j + 2 < n and "answer" in toks[j + 1] and ">" in toks[j + 2]:
                break
            if '"' in tok and not within_label:
                within_label = True
                label = tok.split('"')[1]
                j += 1
                continue
            if '"' in tok and within_label:
                within_label = False
                label = (label + tok.split('"')[0]).strip()
                j += 1
                continue
            if ids[j] >= vocab_size:  # a VRT token
                within_label = False
                positions = []
                patch_ids = []
                vrt_str = ""
                while j < n and ids[j] >= vocab_size:
                    positions.append(j)
                    patch_ids.append(int(ids[j]) - vocab_size)
                    vrt_str += toks[j]
                    j += 1
                objs.append(
                    ParsedObject(
                        sample=sample_idx,
                        label=label,
                        vrt_string=vrt_str,
                        positions=positions,
                        patch_ids=patch_ids,
                    )
                )
                continue
            if within_label:
                label += tok
        j += 1
    return objs


def pack_objects(
    objects: Sequence[ParsedObject],
    max_objects: int,
    max_vrt_per_object: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Objects -> static index arrays for one batched device gather.

    Returns (obj_sample (N,), gather_pos (N, K), vrt_counts (N,), obj_valid (N,)).
    `vrt_feats = hidden[obj_sample[:, None], gather_pos]` gathers each object's
    VRT hidden states. Runs longer than K are truncated to the first K VRTs.
    """
    n = max_objects
    k = max_vrt_per_object
    obj_sample = np.zeros((n,), np.int32)
    gather_pos = np.zeros((n, k), np.int32)
    counts = np.zeros((n,), np.int32)
    valid = np.zeros((n,), bool)
    for oi, obj in enumerate(objects[:n]):
        obj_sample[oi] = obj.sample
        pos = obj.positions[:k]
        gather_pos[oi, : len(pos)] = pos
        counts[oi] = len(pos)
        valid[oi] = len(pos) > 0
    return obj_sample, gather_pos, counts, valid


def gather_vrt_feats(hidden, obj_sample, gather_pos):
    """hidden (B, T, D) -> (N, K, D) on device (one fused gather)."""
    return hidden[obj_sample[:, None], gather_pos]
