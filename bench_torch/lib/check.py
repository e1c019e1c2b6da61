"""`correct` of a served cell: the served tokens of a sample of the
window's queries, held against the plain float32 reference.

The sample is drawn from the seed among the queries the window finished,
and always holds the longest. The reference runs once, teacher-forced over
each sampled prompt and its served tokens, and the number compared is the
widest gap by which a served token's logit lies below the reference's best
(greedy decoding serves the best up to the program's rounding). The
reference's inputs are the benchmark's own, built from each query
(`inputs.py`), and must equal the ones the program built from it; the
weights are the benchmark's tree, read in float32.

With `control`, the control takes the program's place: the reference
computed a step below the configuration's precision, judged by the gap of
the token it puts first, against the same limits.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import inputs, traffic as traffic_gen
from .record import Record, Served


def pick(served: List[Served], n: int, seed: int) -> List[Served]:
    longest = max(range(len(served)), key=lambda i: (len(served[i].tokens), -i))
    rest = [i for i in range(len(served)) if i != longest]
    rng = np.random.default_rng([int(seed), 1])
    chosen = [longest] + list(rng.choice(rest, size=min(n - 1, len(rest)), replace=False))
    return [served[i] for i in sorted(chosen)]


def samples(chosen: List[Served], model: Dict, traffic: Dict, seed: int, ref,
            program_input: Optional[Callable] = None) -> Tuple[List, int]:
    """(the reference's inputs for the chosen queries, built by the
    benchmark from each query; how many of those queries the program built
    another input for). `program_input(query)`, where given, returns the
    (ids, uint8 patch rows, grid) the program builds from the query; the
    window's grid and prompt length are held against the benchmark's too."""
    want = {s.index: s for s in chosen}
    out, differ = [], 0
    same = lambda a, b: np.shape(a) == np.shape(b) and np.array_equal(np.asarray(a), np.asarray(b))
    for q in traffic_gen.queries(traffic, seed):
        if q.index not in want:
            continue
        rows, grid = inputs.patch_rows(inputs.client_image(q.pixels(), traffic["max_side"]), model)
        ids = inputs.prompt_ids(q.prompt, grid, model)
        s = want[q.index]
        ok = tuple(grid) == tuple(s.grid) and len(ids) == s.prompt_tokens
        if program_input is not None:
            p_ids, p_rows, p_grid = program_input(q)
            ok = ok and same(ids, p_ids) and same(rows, p_rows) and same(grid, p_grid)
        differ += not ok
        out.append(ref.Sample(ids=ids, pixels_u8=rows, grid=grid, served=s.tokens))
        if len(out) == len(want):
            return out, differ
    raise AssertionError("unreachable")


def reference(model: Dict):
    return importlib.import_module(f"bench_torch.references.{model['reference']}")


def readings(rec: Record, weights, model: Dict, traffic: Dict, seed: int, device, control: Optional[str] = None,
             program_input: Optional[Callable] = None) -> Tuple[float, Optional[float], int, int]:
    """(the widest gap of the served tokens, the widest gap of the
    control's first choices or None, the tokens compared, the sampled
    queries whose input the program built otherwise)."""
    import torch

    ref = reference(model)
    smp, differ = samples(pick(rec.served, traffic["check_requests"], seed), model, traffic, seed, ref, program_input)
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        gaps, ctrl = ref.served_gaps(weights, model, smp, device, control=control)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    widest = lambda gs: float(max(float(g.max()) for g in gs))
    return widest(gaps), None if ctrl is None else widest(ctrl), int(sum(len(x.served) for x in smp)), differ


def judge(gap: float, n_tok: int, differ: int, limits: Dict) -> Tuple[bool, Dict]:
    """The comparison: each number beside its limit, and whether all hold
    (the gap at most its limit, the tokens at least theirs, the inputs
    that differ at most theirs)."""
    numbers = {
        "max_logit_gap": {"value": gap, "limit": limits["max_logit_gap"]["limit"]},
        "tokens_checked": {"value": n_tok, "limit": limits["tokens_checked"]["limit"]},
        "inputs_differ": {"value": differ, "limit": limits["inputs_differ"]["limit"]},
    }
    ok = (gap <= numbers["max_logit_gap"]["limit"] and n_tok >= numbers["tokens_checked"]["limit"]
          and differ <= numbers["inputs_differ"]["limit"])
    return ok, numbers


def check(rec: Record, weights, model: Dict, traffic: Dict, seed: int, device, limits: Dict,
          control: Optional[str] = None, program_input: Optional[Callable] = None) -> Tuple[bool, Dict]:
    prog, ctrl, n_tok, differ = readings(rec, weights, model, traffic, seed, device, control, program_input)
    return judge(prog if control is None else ctrl, n_tok, differ, limits)
