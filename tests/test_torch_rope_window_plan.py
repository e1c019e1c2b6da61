"""The launch plans of H1 (`cuda_attention.rope_plan`) and H3
(`cuda_attention.window_plan`): pure Python, so they are checked here on the
CPU at every shape the main paths give the two kernels (PaDT-3B's and
PaDT-7B's vision tower, text prefill, train step and decode steps, the
perception decoder's q-only rotary) and at the card tests' shapes
(tests/test_torch_kernels.py). H1: every (row, head, 8-pair vector) is taken
by exactly one thread, and the decode shapes spread over the SMs the plan
promises; H3: every (slot, head, batch row) is walked exactly once, in
turns by the CTA's two consumer warpgroups, and a CTA's shared memory fits
a block; a replay of H3's ring protocol (the mbarriers' parity waits, the
copies landing in any order, the two warpgroups running at any relative
speed) never lets a warpgroup read a stage before its item has landed, and
never stalls, at the plans' even stage counts. The kernels compute their
units and items by the same formulas (`RopePlan.units`,
`WindowPlan.coords` / `walk`)."""

import random

import numpy as np
import pytest

from padt_tpu_torch import padt_3b, padt_7b, padt_tiny
from padt_tpu_torch.ops import cuda_attention as C

_T3, _T7, _V, _D = padt_3b().text, padt_7b().text, padt_3b().vision, padt_3b().decoder


def _text(rows, t):
    return (rows, t.num_attention_heads, t.num_key_value_heads, t.head_dim)


# (rows, q heads, k heads, hd, a decode step)
PATH_SHAPES = [
    (2 * 2304, _V.num_heads, _V.num_heads, _V.head_dim, False),  # vision tower, 2 images (chip_smoke's line)
    (4 * 2304, _V.num_heads, _V.num_heads, _V.head_dim, False),  # run_batch's 4 images
    (8 * 2304, _V.num_heads, _V.num_heads, _V.head_dim, False),  # the train step's frozen tower, batch 8
    *[(*_text(r, _T3), False) for r in (2 * 640, 4 * 640, 8 * 704, 8 * 32, 8 * 5)],  # prefill, train, suffix, verify
    *[(*_text(r, _T7), False) for r in (4 * 640, 8 * 32)],
    *[(*_text(r, t), True) for t in (_T3, _T7) for r in (4, 8, 16)],  # decode: run_batch 4, the pools 8 and 16
    (8 * 64, _D.num_heads, 0, _D.head_dim, False),  # the decoder's q-only rotary
    (8 * 529, _D.num_heads, 0, _D.head_dim, False),
    (2 * 64, 4, 2, padt_tiny().text.head_dim, False),  # the tiny model on the card
    (2 * 256, 4, 4, padt_tiny().vision.head_dim, False),
]
# tests/test_torch_kernels.py: rows 1, 3, 8, 16, 154, 600 and 4608 at every head dim; the forced plans
CARD_SHAPES = [(r, 16 if r > 1000 else 4, 16 if r > 1000 else 2, hd, False)
               for r in (1, 3, 8, 16, 154, 600, 4608) for hd in (16, 32, 64, 80, 128)] + [(154, 16, 2, 128, False)]
FORCED = [(1, 16), (2, 64), (1, 256), (2, 128)]


def _covered_once(plan):
    rows, heads, vecs = plan.rows, plan.heads, plan.vecs
    n, h, v = plan.units()
    assert ((n >= 0) & (n < rows) & (h >= 0) & (h < heads) & (v >= 0) & (v < vecs)).all()
    counts = np.bincount((n * heads + h) * vecs + v, minlength=rows * heads * vecs)
    assert counts.shape == (rows * heads * vecs,) and (counts == 1).all()


@pytest.mark.parametrize("rows,hq,hk,hd,decode", PATH_SHAPES + CARD_SHAPES)
def test_rope_plan_covers_every_vector_once(rows, hq, hk, hd, decode):
    plan = C.rope_plan(rows, hq + hk, hd)
    assert plan.hd % 16 == 0 and plan.hpt in (1, 2) and plan.hpt * plan.groups >= hq + hk
    assert (plan.hpt - 1) * plan.groups < hq + hk  # no thread of the last head slot is idle throughout
    assert 16 <= plan.block <= 256 and plan.ctas * plan.block >= plan.threads
    _covered_once(plan)


@pytest.mark.parametrize("hpt,block", FORCED)
def test_rope_forced_plans_cover_every_vector_once(hpt, block):
    _covered_once(C.rope_plan(154, 18, 128, hpt=hpt, block=block))
    _covered_once(C.rope_plan(7, 32, 80, hpt=hpt, block=block))


@pytest.mark.parametrize("rows,hq,hk,hd,decode", [s for s in PATH_SHAPES if s[4]])
def test_rope_plan_spreads_decode_over_the_sms(rows, hq, hk, hd, decode):
    """A decode step's few rows: one head a thread, blocks of at most 32,
    and at least ROPE_DECODE_SMS CTAs, so the loads issue at once on that
    many SMs (the block scheduler gives each CTA of so small a grid its
    own SM)."""
    plan = C.rope_plan(rows, hq + hk, hd)
    assert plan.hpt == 1 and plan.block <= 32
    assert min(plan.ctas, C.SMS) >= C.ROPE_DECODE_SMS


@pytest.mark.parametrize("rows,hq,hk,hd,decode", [s for s in PATH_SHAPES if s[0] >= 1024])
def test_rope_plan_fills_the_sms_at_large_row_counts(rows, hq, hk, hd, decode):
    """Large row counts: full blocks, every SM busy, two heads a thread
    (the tables read once for both) only where that still holds."""
    plan = C.rope_plan(rows, hq + hk, hd)
    assert plan.block == C.ROPE_BLOCKS[0] and plan.ctas >= C.SMS
    if plan.hpt > 1:
        assert plan.hpt == C.ROPE_HPT and plan.threads >= C.SMS * C.ROPE_BLOCKS[0]


# (B, S, H, hd): the vision tower's windowed layers (run_batch, chip_smoke's line, the train step's tower),
# the tiny tower, and the card tests
WINDOW_SHAPES = [(2, 2304, 16, 80), (4, 2304, 16, 80), (8, 2304, 16, 80), (2, 256, 4, 16)] + [
    (8, 768, 4, hd) for hd in (16, 32, 64, 80, 128)] + [(2, 448, 3, 80), (2, 768, 4, 80), (2, 64, 1, 128)]


@pytest.mark.parametrize("b,s,h,hd", WINDOW_SHAPES)
@pytest.mark.parametrize("ctas,stages", [(None, None), (1, 2), (7, 6), (500, 4), (66, 2)])
def test_window_plan_walks_every_item_once(b, s, h, hd, ctas, stages):
    plan = C.window_plan(b, s, h, hd, ctas=ctas, stages=stages)
    n_slots = s // C.WINDOW
    assert plan.items == b * n_slots * h
    if ctas is None:
        assert plan.ctas == min(plan.items, C.WINDOW_CTAS)
    seen = np.zeros((n_slots, h, b), dtype=np.int64)
    for cta in range(plan.ctas):
        walk = plan.walk(cta)
        # the two warpgroups in turns, each item from the next stage of the ring
        assert [(wg, st) for _, wg, st in walk] == [(r % 2, r % plan.stages) for r in range(len(walk))]
        for i, _, _ in walk:
            seen[plan.coords(i)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("hd", C.HEAD_DIMS)
def test_window_smem_fits_a_block(hd):
    """The default ring (WINDOW_STAGES stages of Q, K, V tiles), two staging
    tiles and the barriers fit the 227 KB a block may use, and so do the
    sweep's 4 and 6 stages up to hd 80."""
    plan = C.window_plan(8, 2304, 16, hd)
    assert plan.stages == C.WINDOW_STAGES and plan.stages % 2 == 0 and plan.smem <= C.SMEM_LIMIT
    if hd <= 80:
        assert C.window_smem_bytes(hd, 6) <= C.SMEM_LIMIT


class _Barrier:
    """An mbarrier: a phase completes when its arrivals and its transaction
    bytes are all in; a wait on parity p passes once the current phase's
    parity differs from p (so a fresh barrier passes a wait on parity 1)."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, tx=0):
        self.tx += tx
        self.pending -= 1
        self._settle()

    def land(self, n):
        self.tx -= n
        self._settle()

    def _settle(self):
        if self.pending == 0 and self.tx == 0:
            self.phase, self.pending = self.phase + 1, self.count

    def passes(self, parity):
        return (self.phase & 1) != parity


def _replay_ring(n_items: int, stages: int, seed: int) -> str:
    """One CTA of csrc/window_attn.cu with `n_items` items: the producer
    (wait empty, arrive with the stage's bytes, issue its copies), the copies
    landing in a random order, and the two consumer warpgroups (item r to
    warpgroup r % 2 from stage r % stages; wait full, read, 4 warp arrivals
    on empty), each step taken in a random order. "ok", "early" (a
    warpgroup passed its wait on a stage that does not hold its item's
    landed tiles) or "stall"."""
    rnd = random.Random(seed)
    full, empty = [_Barrier(1) for _ in range(stages)], [_Barrier(4) for _ in range(stages)]
    holds = [None] * stages  # (item, landed) of each stage
    copies = []  # (stage, item) in flight
    prod = {"r": 0, "stage": 0, "phase": 0}
    cons = [{"r": wg, "stage": wg % stages, "phase": (wg // stages) & 1} for wg in range(2)]
    while True:
        moves = []
        if prod["r"] < n_items and empty[prod["stage"]].passes(prod["phase"] ^ 1):
            moves.append("p")
        moves += ["t"] * bool(copies)
        moves += [wg for wg in range(2) if cons[wg]["r"] < n_items and full[cons[wg]["stage"]].passes(cons[wg]["phase"])]
        if not moves:
            done = prod["r"] >= n_items and all(c["r"] >= n_items for c in cons)
            return "ok" if done else "stall"
        m = rnd.choice(moves)
        if m == "p":
            st = prod["stage"]
            holds[st] = (prod["r"], False)
            full[st].arrive(tx=3)  # Q, K and V
            copies += [(st, prod["r"])] * 3
            prod["r"] += 1
            prod["stage"] += 1
            if prod["stage"] == stages:
                prod["stage"], prod["phase"] = 0, prod["phase"] ^ 1
        elif m == "t":
            st, item = copies.pop(rnd.randrange(len(copies)))
            if not any(c == (st, item) for c in copies):
                holds[st] = (item, True)
            full[st].land(1)
        else:
            c = cons[m]
            if holds[c["stage"]] != (c["r"], True):
                return "early"
            for _ in range(4):
                empty[c["stage"]].arrive()
            c["r"] += 2
            c["stage"] += 2
            if c["stage"] >= stages:
                c["stage"], c["phase"] = c["stage"] - stages, c["phase"] ^ 1


@pytest.mark.parametrize("stages", [2, 4, 6])
@pytest.mark.parametrize("n_items", [1, 2, 3, 8, 9, 35, 42])
def test_window_ring_protocol_even_stages(n_items, stages):
    """Every item count a CTA gets (1-42 at the path's shapes) at every even
    ring size the plans take: no early read, no stall, under 40 random
    orders of the steps."""
    assert {_replay_ring(n_items, stages, seed) for seed in range(40)} == {"ok"}


def test_window_ring_protocol_odd_stages_read_early():
    """The reason the ring is even: with 3 or 5 stages the warpgroups
    alternate on a stage, and one can pass its wait on a fill that has not
    landed (a barrier still in its phase 0 passes a wait on parity 1). The
    wrapper refuses odd stage counts."""
    for stages in (3, 5):
        assert "early" in {_replay_ring(9, stages, seed) for seed in range(40)}
