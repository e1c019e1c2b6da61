"""The one generator of queries: a traffic file's parameters plus `--seed`.

Queries come in blocks of `block` queries. Every block holds the same
multiset of image sizes, output lengths and expression lengths, each
shuffled by the seed (independently, and anew in every block); the seed
also draws the words of each expression and the pixels of each image. So
every seed offers the same mix and the same amount of work, in another
order, and a window that ends inside a block still sees nearly the mix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np


@dataclass
class Query:
    index: int
    width: int  # px, before the max-side resize
    height: int
    prompt: str
    max_new_tokens: int
    pixel_seed: List[int]

    def pixels(self) -> np.ndarray:
        """(height, width, 3) uint8: seeded noise, made when asked for."""
        return np.random.default_rng(self.pixel_seed).integers(0, 256, (self.height, self.width, 3), dtype=np.uint8)


def _multiset(pairs) -> List:
    return [v for v, n in pairs for _ in range(n)]


def check_traffic(t: Dict) -> None:
    b = t["block"]
    for key in ("image_sizes", "output_lengths", "expression_words"):
        if sum(n for _, n in t[key]) != b:
            raise ValueError(f"traffic {key}: the counts sum to {sum(n for _, n in t[key])}, not the block of {b}")


def queries(t: Dict, seed: int) -> Iterator[Query]:
    """The seed's endless stream of queries."""
    check_traffic(t)
    b = t["block"]
    sizes, lengths, words = _multiset(t["image_sizes"]), _multiset(t["output_lengths"]), _multiset(t["expression_words"])
    vocab = t["words"]
    rng = np.random.default_rng(seed)
    block = 0
    while True:
        ps, pl, pw = rng.permutation(b), rng.permutation(b), rng.permutation(b)
        for j in range(b):
            i = block * b + j
            w, h = sizes[ps[j]]
            expr = " ".join(vocab[k] for k in rng.integers(0, len(vocab), words[pw[j]]))
            yield Query(
                index=i, width=int(w), height=int(h), prompt=t["template"].format(expr=expr),
                max_new_tokens=int(lengths[pl[j]]), pixel_seed=[int(seed), i],
            )
        block += 1
