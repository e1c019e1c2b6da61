"""Minimal offline tokenizer with the HF surface the VRT processor needs (the
port's copy of `padt_tpu/utils/mock_tokenizer.py`).

Used by tests and the random-weight demo: greedy longest-match on
special/added tokens, character-level fallback. Real deployments pass an HF
`AutoTokenizer` loaded from the checkpoint directory instead (the tokenizer is
a pure data dependency — SURVEY.md §2.3)."""

from __future__ import annotations

from typing import Dict, List, Sequence


class MockTokenizer:
    def __init__(self, specials: Sequence[str] = (), base_vocab_size: int = 256):
        # ids [0, base_vocab_size): raw byte/char tokens
        self._vocab: Dict[str, int] = {chr(i): i for i in range(base_vocab_size)}
        self._ids: Dict[int, str] = {i: chr(i) for i in range(base_vocab_size)}
        for s in specials:
            self.add_tokens([s], special_tokens=True)

    @property
    def eos_token(self) -> str:
        return "<|im_end|>"

    def get_vocab(self) -> Dict[str, int]:
        return dict(self._vocab)

    def __len__(self) -> int:
        return len(self._vocab)

    def add_tokens(self, tokens: Sequence[str], special_tokens: bool = False) -> int:
        added = 0
        for t in tokens:
            if t not in self._vocab:
                idx = len(self._vocab)
                self._vocab[t] = idx
                self._ids[idx] = t
                added += 1
        return added

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        # greedy longest-match over multi-char tokens, else per-char
        multi = sorted((t for t in self._vocab if len(t) > 1), key=len, reverse=True)
        ids: List[int] = []
        i = 0
        while i < len(text):
            for t in multi:
                if text.startswith(t, i):
                    ids.append(self._vocab[t])
                    i += len(t)
                    break
            else:
                ids.append(self._vocab.setdefault(text[i], len(self._vocab)))
                self._ids[ids[-1]] = text[i]
                i += 1
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self._ids.get(int(i), "<unk>") for i in ids)

    def batch_decode(self, seqs: Sequence[Sequence[int]]) -> List[str]:
        return [self.decode(s) for s in seqs]


def make_tiny_tokenizer(cfg) -> MockTokenizer:
    """Tokenizer aligned with `padt_tiny()` special-token ids: pads the vocab so
    that each special lands exactly at its configured id."""
    tok = MockTokenizer()
    tok.add_tokens(["<|im_start|>"], special_tokens=True)
    specials = {
        cfg.vision_start_token_id: "<|vision_start|>",
        cfg.vision_start_token_id + 1: "<|vision_end|>",  # convention for tiny cfg
        cfg.image_token_id: "<|image_pad|>",
        cfg.video_token_id: "<|video_pad|>",
        cfg.pad_token_id: "<|endoftext|>",
        cfg.eos_token_id: "<|im_end|>",
    }
    assert len(set(specials)) == len(specials), "tiny special-token ids collide"
    next_free = len(tok)
    for tid in sorted(specials):
        assert tid >= next_free, f"special id {tid} already taken"
        while next_free < tid:
            tok.add_tokens([f"<|filler_{next_free}|>"], special_tokens=True)
            next_free += 1
        tok.add_tokens([specials[tid]], special_tokens=True)
        next_free += 1
    # pad up to vocab_size (model_embed_token_size)
    while len(tok) < cfg.text.vocab_size:
        tok.add_tokens([f"<|empty_token_{len(tok)}|>"], special_tokens=True)
    return tok


class FastMockTokenizer(MockTokenizer):
    """MockTokenizer with an O(n) encode for FULL-SIZE vocabs.

    The base encode does greedy longest-match over every multi-char token per
    position — pathological at the 152k-token Qwen id space. All multi-char
    tokens that can appear in real prompts are `<|...|>` forms, so split on
    that shape and look the pieces up; everything else is per-char."""

    _SPECIAL_RE = None

    def encode(self, text: str, add_special_tokens: bool = False):
        import re

        if FastMockTokenizer._SPECIAL_RE is None:
            FastMockTokenizer._SPECIAL_RE = re.compile(r"(<\|[^|<>]*\|>)")
        ids = []
        for part in FastMockTokenizer._SPECIAL_RE.split(text):
            if len(part) > 1 and part in self._vocab:
                ids.append(self._vocab[part])
            else:
                for ch in part:
                    tid = self._vocab.setdefault(ch, len(self._vocab))
                    self._ids[tid] = ch
                    ids.append(tid)
        return ids


def make_full_tokenizer(cfg) -> FastMockTokenizer:
    """`make_tiny_tokenizer`'s id-layout contract at FULL config scale
    (special ids ~151643+): bulk filler placement + fast encode. For
    random-weight benchmarks of 3B/7B shapes (scripts/infer_eval.py
    --model random:3b); real deployments load the HF tokenizer."""
    tok = FastMockTokenizer()
    tok.add_tokens(["<|im_start|>"], special_tokens=True)
    specials = {
        cfg.vision_start_token_id: "<|vision_start|>",
        cfg.vision_start_token_id + 1: "<|vision_end|>",
        cfg.image_token_id: "<|image_pad|>",
        cfg.video_token_id: "<|video_pad|>",
        cfg.pad_token_id: "<|endoftext|>",
        cfg.eos_token_id: "<|im_end|>",
    }
    next_free = len(tok)
    for tid in sorted(specials):
        assert tid >= next_free, f"special id {tid} already taken"
        tok.add_tokens(
            [f"<|filler_{i}|>" for i in range(next_free, tid)], special_tokens=True
        )
        tok.add_tokens([specials[tid]], special_tokens=True)
        next_free = tid + 1
    if len(tok) < cfg.text.vocab_size:
        tok.add_tokens(
            [f"<|empty_token_{i}|>" for i in range(len(tok), cfg.text.vocab_size)],
            special_tokens=True,
        )
    return tok
