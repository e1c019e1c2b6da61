"""Continuous-batching serve engine on PyTorch (port of
`padt_tpu/serve/engine.py`): a fixed pool of decode slots over one int8 KV
cache; finished slots are harvested and refilled from a request queue while
the rest of the pool keeps decoding.

The device-side functions keep the JAX package's names and semantics, with
two differences of form: the decode state is a mutable dataclass updated IN
PLACE (the cache rows through the H6 store kernel, the other leaves by
index assignment, `copy_` and `add_`: each leaf keeps its tensor, and so
its address, for the engine's life), and a decode chunk is a Python loop
that reads `active.any()` once per step, where JAX ran one `while_loop`
program. On the card the plain steps of a chunk replay one CUDA graph of
the step, captured once per engine, and each plain admission (tower,
prefill, insert) replays one CUDA graph of its bucket shape, captured once
per shape and engine: two instances of `Graphs`, which holds the one rule
of when to capture, the graphs' static inputs, launch tallies and
counters. Every admission's host data reaches the device through
`_upload`'s copies from page-locked memory, which do not wait.

On the card every decode step runs H4 (`int8_decode_attn`) in every layer
and one H6 store; every suffix pass and speculative verify runs H5
(`int8_verify_attn`) in every layer and one H6 store. On int8 weights every
text-layer product of every forward runs H7 (`int8_matmul`, through
`language.int8_layers`). On a sparse-expert stack (`TextConfig.num_experts`)
every forward's expert products run H11 (`expert_matmul`, two a layer),
inside the graph too, and the state's `moe_tally` counts on the device the
token-expert choices of real tokens and the experts they hit; it travels
with each chunk's flag readback into `ServeStats`. An engine refuses a KV
capacity past the keys a model's sparse-attention indexer keeps
(`TextConfig.sa_topk`): the port has no indexer.

`ServeStats.prefill_s` / `decode_s` are device time between CUDA events,
read at each chunk's flag readback (host clock on the CPU, where work is
synchronous): the JAX engine's `prefill_s` measured dispatch only and its
device prefill landed in `decode_s`. Host time goes to a
`utils.profiling.Recorder` in spans named after the code they cover
(`serve.run`, `serve.admit` > `admit.{stack,vision,prefill,insert,suffix,
capture,graph}` (`vision`, `prefill`, `insert` on eager admissions),
`serve.decode_chunk` > `decode.readback`, `decode.capture` and
`decode.step` > `decode.{logits,layers,store}` (eager steps only; with
experts `moe.route` / `moe.experts` inside `decode.layers` and
`admit.prefill`), `serve.flag_readback`, `serve.harvest` >
`harvest.readback`, `tokens.readback`). A span whose name ends in
`.readback` holds a call that blocks the host until the device has run the
work queued before it: a readback, or a synchronous copy to the device. A
`decode.<part>.readback` lies inside `decode.step`. Not ported:
`MultiEngine` (one replica per card, with the parallel slice) and
`_pack_transient_fits` (a memory guard for a 16 GB TPU).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import PaDTConfig, text_opt
from ..models import language
from ..models import padt as padt_model
from ..ops import launch_tallies
from ..ops.kv_cache import (
    decode_attention_int8,
    decode_attention_int8_multi,
    store_kv_rows_all_layers,
    store_kv_rows_k_all_layers,
)
from ..ops.moe import Tally
from ..ops.rope import mrope_cos_sin
from ..utils.profiling import Recorder


@dataclass
class DecodeState:
    """Per-slot decode pool; the leading dim of every tensor (after the
    cache's layer dim) is n_slots. Mutated in place."""

    k8: torch.Tensor  # (L, B, Hkv, C, hd) int8
    ks: torch.Tensor  # (L, B, Hkv, C) fp32
    v8: torch.Tensor
    vs: torch.Tensor
    valid: torch.Tensor  # (B, C) bool: live cache rows
    write_pos: torch.Tensor  # (B,) int64: next cache row to write
    text_pos: torch.Tensor  # (B,) int64: next rope position
    cur_hidden: torch.Tensor  # (B, 1, D): hidden that predicts the next token
    proto: torch.Tensor  # (B, M, D): per-slot VRT prototype table
    num_merged: torch.Tensor  # (B,)
    tokens: torch.Tensor  # (B, T) int64: generated tokens
    hidden_out: torch.Tensor  # (B, T, D): hidden that produced each token
    n_gen: torch.Tensor  # (B,) int64
    budget: torch.Tensor  # (B,) int64: per-request max_new_tokens
    active: torch.Tensor  # (B,) bool
    ctx: torch.Tensor  # (B, C) int64: prompt suffix + generated tokens (draft lookups)
    ctx_len: torch.Tensor  # (B,) int64
    # sparse experts: choices of real tokens and (layer, expert) pairs they hit, summed on the
    # device since the run started: decode choices, decode hits, prefill choices, prefill hits
    moe_tally: torch.Tensor  # (4,) int64
    moe_counts: torch.Tensor  # (L, E) int32: one forward's choices per (layer, expert), then folded
    generator: torch.Generator  # sampling stream (unused under greedy)
    steps: int = 0  # decode / verify forwards run since the run started


@dataclass
class PrefillPack:
    """Everything `insert` needs to splice R prefilled requests into slots."""

    k8: torch.Tensor  # (L, R, Hkv, C, hd)
    ks: torch.Tensor
    v8: torch.Tensor
    vs: torch.Tensor
    valid: torch.Tensor  # (R, C)
    write_pos: torch.Tensor  # (R,)
    text_pos: torch.Tensor  # (R,)
    cur_hidden: torch.Tensor  # (R, 1, D)
    proto: torch.Tensor  # (R, M, D)
    num_merged: torch.Tensor  # (R,)
    prompt_ctx: torch.Tensor  # (R, C): real prompt tokens left-aligned, then -1
    prompt_len: torch.Tensor  # (R,)


_PACK_KV = ("k8", "ks", "v8", "vs")  # PrefillPack leaves with the batch at dim 1


def init_state(
    cfg: PaDTConfig,
    n_slots: int,
    capacity: int,
    max_new_tokens: int,
    dtype=torch.bfloat16,
    device="cpu",
    patch_bucket: Optional[int] = None,
    seed: int = 0,
) -> DecodeState:
    t = cfg.text
    nl, hkv, hd, d = t.num_hidden_layers, t.num_key_value_heads, t.head_dim, t.hidden_size
    m = (patch_bucket or cfg.max_image_patches) // cfg.vision.spatial_merge_unit
    z = lambda *shape, dt=torch.int64: torch.zeros(shape, dtype=dt, device=device)
    return DecodeState(
        k8=z(nl, n_slots, hkv, capacity, hd, dt=torch.int8),
        ks=z(nl, n_slots, hkv, capacity, dt=torch.float32),
        v8=z(nl, n_slots, hkv, capacity, hd, dt=torch.int8),
        vs=z(nl, n_slots, hkv, capacity, dt=torch.float32),
        valid=z(n_slots, capacity, dt=torch.bool),
        write_pos=z(n_slots),
        text_pos=z(n_slots),
        cur_hidden=z(n_slots, 1, d, dt=dtype),
        proto=z(n_slots, m, d, dt=dtype),
        num_merged=z(n_slots),
        tokens=torch.full((n_slots, max_new_tokens), cfg.pad_token_id, dtype=torch.int64, device=device),
        hidden_out=z(n_slots, max_new_tokens, d, dt=dtype),
        n_gen=z(n_slots),
        budget=z(n_slots),
        active=z(n_slots, dt=torch.bool),
        ctx=torch.full((n_slots, capacity), -1, dtype=torch.int64, device=device),
        ctx_len=z(n_slots),
        moe_tally=z(4),
        moe_counts=z(nl, text_opt(t, "num_experts"), dt=torch.int32),
        generator=torch.Generator(device=device).manual_seed(seed),
    )


def prefill(
    params, cfg: PaDTConfig, batch: Dict[str, torch.Tensor], rope_deltas, capacity: int,
    return_artifacts: bool = False, *, rec: Recorder, real_rows: Optional[torch.Tensor] = None,
    tally: Optional[Tally] = None,
):
    """Vision + causal int8 prefill for a request bucket -> insertable pack
    (and the bucket's `VisionArtifacts` with return_artifacts). Host spans
    `admit.vision` and `admit.prefill` (with experts, `moe.*` inside it) go
    to `rec`. With experts, `tally` gains the choices of the prompt tokens
    of the rows `real_rows` (R,) bool marks on the device (every row where
    it is None; the others pad the bucket) and the (layer, expert) pairs
    they hit. It reads nothing back to the host, so a CUDA graph of it
    replays on new inputs in the same tensors."""
    ids = batch["input_ids"]
    r, l = ids.shape
    dev = ids.device
    with rec.span("admit.vision"):
        art = padt_model.run_vision(params, cfg, batch)
    with rec.span("admit.prefill"):
        embeds = padt_model.extended_embed(params, cfg, ids, art.proto, art.merged)
        valid = batch["attention_mask"].bool()
        real = None
        if tally is not None:
            real = valid if real_rows is None else valid & real_rows[:, None]
        hidden, qc = language.prefill(
            params["text"], cfg.text, embeds, batch["position_ids"], valid, capacity, kv_dtype="int8",
            real=real, tally=tally, rec=rec,
        )
        # left-aligned prompt context for draft lookups (prompts are LEFT padded)
        plen = valid.sum(-1)
        cols = torch.arange(capacity, device=dev)[None, :]
        src = (l - plen[:, None] + cols).clamp(0, l - 1)
        ctx = torch.where(cols < plen[:, None], torch.gather(ids.long(), 1, src), -1)
        pack = PrefillPack(
            k8=qc.k, ks=qc.k_scale, v8=qc.v, vs=qc.v_scale, valid=qc.valid,
            write_pos=torch.full((r,), l, dtype=torch.int64, device=dev),
            text_pos=(l + rope_deltas.to(dev)).long(),
            cur_hidden=hidden[:, -1:, :],
            proto=art.proto,
            num_merged=art.num_merged.long(),
            prompt_ctx=ctx,
            prompt_len=plen,
        )
    return (pack, art) if return_artifacts else pack


def insert(state: DecodeState, pack: PrefillPack, slots: torch.Tensor, budgets: torch.Tensor) -> DecodeState:
    """Splice R prefilled requests into the given slots, in place. A budget
    <= 0 marks a padding request: its slot stays idle. tokens / hidden_out
    rows are not reset: a harvest reads only [:n_gen], all of which the new
    occupant rewrites."""
    for f in _PACK_KV:
        getattr(state, f)[:, slots] = getattr(pack, f)
    state.valid[slots] = pack.valid
    state.write_pos[slots] = pack.write_pos
    state.text_pos[slots] = pack.text_pos
    state.cur_hidden[slots] = pack.cur_hidden.to(state.cur_hidden.dtype)
    state.proto[slots] = pack.proto.to(state.proto.dtype)
    state.num_merged[slots] = pack.num_merged
    state.n_gen.index_fill_(0, slots, 0)  # `[slots] = 0` would copy the 0 to the device and wait
    state.budget[slots] = budgets
    state.active[slots] = budgets > 0
    state.ctx[slots] = pack.prompt_ctx
    state.ctx_len[slots] = pack.prompt_len
    return state


def _moe_counts(tcfg, state: DecodeState, phase: int, real, rec: Recorder) -> Dict[str, Any]:
    """`int8_layers`' MoE arguments: the state's decode (phase 0) or
    prefill (1) tally, the real rows and the recorder; none for a dense
    stack."""
    if not text_opt(tcfg, "num_experts"):
        return {}
    if real is None:
        return {"rec": rec}
    return {"real": real, "tally": _tally(state, phase), "rec": rec}


def _tally(state: DecodeState, phase: int) -> Tally:
    """The state's decode (phase 0) or prefill (1) expert tally."""
    return Tally(state.moe_counts, state.moe_tally[2 * phase : 2 * phase + 2])


def _decode_step_slots(params, tcfg, inputs_embeds, state: DecodeState, *, rec: Recorder, real=None) -> torch.Tensor:
    """One decode step over the pool with per-slot cache positions; returns
    the post-norm hidden (B, 1, D) and updates the state's cache and `valid`
    in place. The layer loop reads the pre-update cache (H4 with the current
    token as its fresh column); one H6 launch then writes every layer's row
    at each slot's own position. Inactive slots run too: their outputs are
    discarded and their clamped row writes land in caches never read again.
    With experts the slots `real` (B,) marks are counted in the state's
    decode tally. The host's time goes to `rec` as `decode.layers` and
    `decode.store`."""
    b = inputs_embeds.shape[0]
    with rec.span("decode.layers"):
        pos3 = state.text_pos[None, :, None].expand(3, b, 1)
        cos, sin = mrope_cos_sin(pos3, tcfg.head_dim, tcfg.mrope_section, tcfg.rope_theta)
        # a drained slot's write_pos can equal capacity (prompt + budget ==
        # capacity): clamp its store into range
        capacity = state.valid.shape[1]
        store_pos = state.write_pos.clamp(max=capacity - 1)
        rows = torch.arange(b, device=store_pos.device)
        now_valid = state.valid[rows, store_pos] | state.active
        hidden, new_rows = language.int8_layers(
            params, tcfg, inputs_embeds, cos, sin,
            lambda q, li, fresh: decode_attention_int8(
                q, state.k8, state.ks, state.v8, state.vs, state.valid, layer=li, fresh_kv=fresh,
            ),
            **_moe_counts(tcfg, state, 0, real if real is None else real[:, None], rec),
        )
    with rec.span("decode.store"):
        store_kv_rows_all_layers(state.k8, state.ks, state.v8, state.vs, *new_rows, store_pos)
        state.valid[rows, store_pos] = now_valid
    return hidden


def _decode_spec_slots(
    params, tcfg, inputs_embeds, state: DecodeState, store_pos, active_mask=None, n_store_rows=None,
    *, rec: Recorder, prefill_rows: bool = False,
):
    """K-token verify forward over the pool: the K tokens' K/V are stored at
    store_pos..store_pos+K-1 and all K queries attend over one cache read
    (H5, causal inside the block). Returns hidden (B, K, D); updates the
    cache and `valid` in place.

    `active_mask` (B,) selects the slots whose new rows become valid (default
    `state.active`). `n_store_rows` (B,) limits how many of the K rows are
    physically written per slot (default K): a slot outside a pool-wide
    suffix pass passes 0, since its clamped store_pos may land on live rows.
    With experts, the rows written count in the state's decode tally, or
    its prefill tally for a suffix pass (`prefill_rows`).
    The host's time goes to `rec` as `decode.layers` and `decode.store`."""
    if active_mask is None:
        active_mask = state.active
    b, kq, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    with rec.span("decode.layers"):
        pos3 = state.text_pos[None, :, None].expand(3, b, kq) + torch.arange(kq, device=dev)[None, None, :]
        cos, sin = mrope_cos_sin(pos3, tcfg.head_dim, tcfg.mrope_section, tcfg.rope_theta)
        cols = torch.arange(state.valid.shape[1], device=dev)[None, :]
        newly = (cols >= store_pos[:, None]) & (cols < store_pos[:, None] + kq)
        new_valid = state.valid | (newly & active_mask[:, None])
        real = None
        if text_opt(tcfg, "num_experts"):  # the rows written, for the expert tally
            real = torch.arange(kq, device=dev)[None, :] < (kq if n_store_rows is None else n_store_rows[:, None])
            real &= active_mask[:, None]
        hidden, new_rows = language.int8_layers(
            params, tcfg, inputs_embeds, cos, sin,
            lambda q, li, fresh: decode_attention_int8_multi(
                q, state.k8, state.ks, state.v8, state.vs, state.valid, store_pos, layer=li, fresh_kv=fresh,
            ),
            **_moe_counts(tcfg, state, 1 if prefill_rows else 0, real, rec),
        )
    with rec.span("decode.store"):
        store_kv_rows_k_all_layers(state.k8, state.ks, state.v8, state.vs, *new_rows, store_pos, n_rows=n_store_rows)
        state.valid.copy_(new_valid)
    return hidden


_SUFFIX_K = 32  # per-pass suffix width (the row store's bound)


def _suffix_prefill_step(
    params, cfg: PaDTConfig, state: DecodeState, inputs: torch.Tensor, slen: torch.Tensor, *, rec: Recorder,
) -> DecodeState:
    """One K=32 suffix pass over the pool (prefix KV caching), in place.

    Slots admitted with a cached shared prefix already hold its KV; this
    pass runs their suffix tokens (RIGHT padded to K; `inputs` (B, K), pad
    rows for slots outside the admission, whose `slen` is 0) through the
    verify machinery. Only the `slen` real rows become valid and are stored
    (slots with slen 0 keep every byte); `cur_hidden` moves to the last real
    suffix token's hidden, the one that predicts the first new token."""
    kq = inputs.shape[1]
    dev = inputs.device
    mask = slen > 0
    emb = padt_model.extended_embed(params, cfg, inputs, state.proto)
    cap = state.valid.shape[1]
    store_pos = state.write_pos.clamp(max=cap - kq)
    hid = _decode_spec_slots(params["text"], cfg.text, emb, state, store_pos, active_mask=mask, n_store_rows=slen,
                             rec=rec, prefill_rows=True)
    # drop the right-pad rows: keep [0, write_pos) and [store_pos, store_pos + slen)
    cols = torch.arange(cap, device=dev)[None, :]
    state.valid &= (cols < (store_pos + slen)[:, None]) | (cols < state.write_pos[:, None])
    last = (slen - 1).clamp(0, kq - 1)[:, None, None].expand(-1, 1, hid.shape[-1])
    state.cur_hidden.copy_(torch.where(mask[:, None, None], torch.gather(hid, 1, last).to(state.cur_hidden.dtype), state.cur_hidden))
    # append the real suffix tokens to the draft context
    idxk = torch.arange(kq, device=dev)[None, :]
    rowsk = torch.arange(inputs.shape[0], device=dev)[:, None]
    ctx_idx = (state.ctx_len[:, None] + idxk).clamp(0, cap - 1)
    emit = idxk < slen[:, None]
    state.ctx[rowsk, ctx_idx] = torch.where(emit, inputs.long(), state.ctx[rowsk, ctx_idx])
    for t in (state.ctx_len, state.write_pos, state.text_pos):
        t.add_(slen)
    return state


def _pack_slice(pack: PrefillPack, i: int) -> PrefillPack:
    """Row i of a pack as a one-row pack (views)."""
    return PrefillPack(**{
        f.name: getattr(pack, f.name)[:, i : i + 1] if f.name in _PACK_KV else getattr(pack, f.name)[i : i + 1]
        for f in fields(PrefillPack)
    })


def _pack_concat(rows: List[PrefillPack]) -> PrefillPack:
    """Stack one-row packs into one insertable R-row pack."""
    return PrefillPack(**{
        f.name: torch.cat([getattr(p, f.name) for p in rows], dim=1 if f.name in _PACK_KV else 0)
        for f in fields(PrefillPack)
    })


def _bigram_draft(ctx, ctx_len, last1, t0, kq: int):
    """Prompt-lookup drafting: the kq-1 tokens that followed the most recent
    bigram (last1, t0) in each slot's context; pad (0) drafts without a match."""
    b, c = ctx.shape
    idx = torch.arange(c, device=ctx.device)
    nxt = torch.cat([ctx[:, 1:], torch.full((b, 1), -1, dtype=ctx.dtype, device=ctx.device)], dim=1)
    match = (ctx == last1[:, None]) & (nxt == t0[:, None]) & (idx[None, :] + 1 < ctx_len[:, None])
    j = torch.where(match, idx[None, :], -1).amax(dim=1)  # last match or -1
    gidx = (j[:, None] + 2 + torch.arange(kq - 1, device=ctx.device)[None, :]).clamp(0, c - 1)
    draft = torch.gather(ctx, 1, gidx)
    return torch.where((j >= 0)[:, None] & (draft >= 0), draft, 0)


def decode_chunk_spec(
    params,
    cfg: PaDTConfig,
    state: DecodeState,
    n_steps: int,
    draft_k: int,
    *,
    rec: Recorder,
) -> DecodeState:
    """Speculative (greedy-only) decode chunk, in place: each macro-step
    drafts draft_k - 1 tokens by prompt lookup, verifies them and the base
    token in one K-token forward, and emits 1..draft_k tokens. Token-identical
    to plain greedy decoding: the model's own argmax decides every emitted
    token. Stops early when the pool drains. Host spans as `decode_chunk`'s,
    with `decode.logits` twice a step (the draft, then the acceptance) and
    `decode.emit.readback` inside the second."""
    eos = cfg.eos_token_id
    b, t_cap = state.tokens.shape
    kq = draft_k
    cap = state.valid.shape[1]
    dev = state.tokens.device
    idxk = torch.arange(kq, device=dev)[None, :]
    rowsk = torch.arange(b, device=dev)[:, None]
    for _ in range(n_steps):
        with rec.span("decode.readback"):
            if not bool(state.active.any()):
                break
        with rec.span("decode.step"):
            st = state
            with rec.span("decode.logits"):
                logits0 = padt_model.extended_logits(params, cfg, st.cur_hidden, st.proto, st.num_merged)[:, 0]
                t0 = torch.where(st.active, torch.argmax(logits0, dim=-1), cfg.pad_token_id)
                last1 = torch.gather(st.ctx, 1, (st.ctx_len[:, None] - 1).clamp(0, cap - 1))[:, 0]
                draft = _bigram_draft(st.ctx, st.ctx_len, last1, t0, kq)
                inputs = torch.cat([t0[:, None], draft], dim=1)  # (B, K)

                emb = padt_model.extended_embed(params, cfg, inputs, st.proto)
            store_pos = st.write_pos.clamp(max=cap - kq)
            hid = _decode_spec_slots(params["text"], cfg.text, emb, st, store_pos, rec=rec)
            with rec.span("decode.logits"):
                g = torch.argmax(padt_model.extended_logits(params, cfg, hid, st.proto, st.num_merged), dim=-1)

                # longest accepted draft prefix: draft[:, i] must equal g[:, i]
                acc = torch.cumprod((draft == g[:, :-1]).long(), dim=1).sum(dim=1)
                emitted = 1 + acc
                # stop at the first EOS among the emitted tokens, then at the budget
                is_eos = inputs == eos
                eos_pos = torch.where(is_eos & (idxk < emitted[:, None]), idxk, kq).amin(dim=1)
                emitted = torch.minimum(emitted, eos_pos + 1)
                emitted = torch.minimum(emitted, st.budget - st.n_gen)
                emitted = torch.where(st.active, emitted, 0)
                hit_eos = (eos_pos < kq) & (emitted == eos_pos + 1) & st.active

                # tokens and the hidden that produced each at n_gen..n_gen+emitted;
                # only emitted cells are written (a clamped index near the end of the
                # buffer must not overwrite an emitted one)
                emit_mask = idxk < emitted[:, None]
                with rec.span("decode.emit.readback"):  # nonzero reads the count back
                    sel_b, sel_k = emit_mask.nonzero(as_tuple=True)
                sel_t = st.n_gen[sel_b] + sel_k
                prod_hid = torch.cat([st.cur_hidden, hid[:, : kq - 1].to(st.cur_hidden.dtype)], dim=1)  # (B, K, D)
                st.tokens[sel_b, sel_t] = inputs[sel_b, sel_k]
                st.hidden_out[sel_b, sel_t] = prod_hid[sel_b, sel_k]
                ctx_idx = (st.ctx_len[:, None] + idxk).clamp(0, cap - 1)
                st.ctx[rowsk, ctx_idx] = torch.where(emit_mask, inputs, st.ctx[rowsk, ctx_idx])

                # invalidate rejected rows: positions >= store_pos + emitted (write_pos moves below)
                cols = torch.arange(cap, device=dev)[None, :]
                st.valid &= (cols < (store_pos + emitted)[:, None]) | (cols < st.write_pos[:, None])
                # next carried hidden: the one after exactly `emitted` tokens
                last = (emitted - 1).clamp(0, kq - 1)[:, None, None].expand(-1, 1, hid.shape[-1])
                st.cur_hidden.copy_(torch.where(st.active[:, None, None], torch.gather(hid, 1, last).to(st.cur_hidden.dtype), st.cur_hidden))

                for t in (st.n_gen, st.ctx_len, st.write_pos, st.text_pos):
                    t.add_(emitted)
                st.active &= ~hit_eos & (st.n_gen < st.budget)
                st.steps += 1
    return state


def _plain_step(params, cfg: PaDTConfig, state: DecodeState, sampling: Tuple, *, rec: Recorder) -> None:
    """One plain decode step over the pool, in place: logits, token
    selection, the token / hidden / `n_gen` bookkeeping, the new token's
    embedding, the text layers, H6's store, then `write_pos`, `text_pos`
    and `active`. It reads and writes only the state's tensors, the weights
    and tensors it makes itself, so a CUDA graph of it replays on the state
    as that then stands."""
    eos = cfg.eos_token_id
    b, t_cap = state.tokens.shape
    st = state
    with rec.span("decode.logits"):
        rows = torch.arange(b, device=st.tokens.device)
        logits = padt_model.extended_logits(params, cfg, st.cur_hidden, st.proto, st.num_merged)[:, 0]
        tok = padt_model.sample_token(logits, st.generator, *sampling)
        tok = torch.where(st.active, tok, cfg.pad_token_id)
        idx = st.n_gen.clamp(0, t_cap - 1)
        st.tokens[rows, idx] = torch.where(st.active, tok, st.tokens[rows, idx])
        st.hidden_out[rows, idx] = torch.where(st.active[:, None], st.cur_hidden[:, 0], st.hidden_out[rows, idx])
        st.n_gen.add_(st.active.long())
        active = st.active & (tok != eos) & (st.n_gen < st.budget)
        # the next forward runs for the whole pool; inactive slots' writes
        # are masked through valid / write_pos
        emb = padt_model.extended_embed(params, cfg, tok[:, None], st.proto)
    st.cur_hidden.copy_(_decode_step_slots(params["text"], cfg.text, emb, st, rec=rec, real=active))
    moved = st.active.long()
    st.write_pos.add_(moved)
    st.text_pos.add_(moved)
    st.active.copy_(active)


ADMISSION_GRAPHS = 4  # live admission graphs an engine keeps; an admission of another bucket shape runs eagerly


def _upload(host, device: torch.device, into=None):
    """Host tensors (a tensor, or a tuple or dict of them; page-locked where
    `device` is the card) -> `device`, by copies that do not wait for the
    card (the host allocator keeps a page-locked block until its copy has
    run): into the tensors `into` where given, else into new ones. On the
    CPU, new ones are the host tensors themselves."""
    if isinstance(host, dict):
        return {k: _upload(v, device, None if into is None else into[k]) for k, v in host.items()}
    if isinstance(host, tuple):
        return tuple(_upload(v, device, None if into is None else into[i]) for i, v in enumerate(host))
    if into is not None:
        return into.copy_(host, non_blocking=True)
    return host.to(device, non_blocking=True)


class Graphs:
    """Work captured as CUDA graphs, keyed by shape, and replayed.

    `graphs(key, body, rec, *inputs)` runs `body(rec, *inputs on the
    device)`, by one rule for every key: on the card the first call of a
    key runs eagerly (it builds the kernels, sets their attributes and
    settles cuBLAS's workspace), the second captures `body` (nothing runs)
    and replays it, and later calls replay. At most `limit` graphs are kept,
    in one memory pool (they run one at a time); a key past that, and every
    call on the CPU, runs eagerly (`limit = 0`: every call). A graph reads
    its inputs from static device tensors that each call fills by
    `_upload`'s copies, and what it returns (None or a tuple of tensors)
    from the memory the next replay rewrites, so a call returns a copy.
    Everything else a body reads (the weights, the state's tensors, module
    settings such as `kv_cache._QI8_DEFAULT`, the sampling generator, which
    the capture registers) is read in place or fixed at the capture.

    The kernel wrappers' launch tallies (`ops.launch_tallies`) count a
    replay's launches as those of the body captured; the capture's own
    calls are taken back out. `replays` (the capturing call included) and
    `captures` count since `reset`. Host spans: `capture_span` around a
    capture, `replay_span` around a replay and its copies."""

    def __init__(self, limit: int, device: torch.device, capture_span: str, replay_span: str):
        self.limit = limit
        self.device = device
        self.capture_span, self.replay_span = capture_span, replay_span
        # every key called: None until captured, then (graph, static inputs, what it returns, the launches
        # a replay adds as (tally, key, count))
        self.graphs: Dict[Any, Optional[Tuple]] = {}
        self.pool = None  # the graphs' memory pool, from the first capture on
        self.replays = self.captures = 0

    def reset(self) -> None:
        self.replays = self.captures = 0

    def __call__(self, key, body, rec: Recorder, *inputs, generator: Optional[torch.Generator] = None):
        if self.graphs.get(key) is None:
            if not (key in self.graphs and self.device.type == "cuda"
                    and sum(g is not None for g in self.graphs.values()) < self.limit):
                self.graphs[key] = None
                return body(rec, *_upload(inputs, self.device))
            with rec.span(self.capture_span):
                self.capture(key, body, inputs, generator)
        with rec.span(self.replay_span):
            return self.replay(key, *inputs)

    def capture(self, key, body, inputs: Tuple = (), generator: Optional[torch.Generator] = None) -> None:
        """Capture `body(Recorder(), *static inputs)` as `key`'s graph; the
        static inputs are device copies of `inputs`."""
        statics = _upload(inputs, self.device)
        g = torch.cuda.CUDAGraph()
        if generator is not None:
            g.register_generator_state(generator)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        tallies = launch_tallies()
        before = [dict(t) for t in tallies]
        with torch.cuda.graph(g, pool=self.pool, capture_error_mode="thread_local"):  # other threads may use the card
            out = body(Recorder(), *statics)
        launches = [(t, k, n - b.get(k, 0)) for t, b in zip(tallies, before) for k, n in t.items() if n != b.get(k, 0)]
        for t, b in zip(tallies, before):
            t.clear()
            t.update(b)
        self.graphs[key] = (g, statics, out, launches)
        self.captures += 1

    def replay(self, key, *inputs):
        """Copy `inputs` into `key`'s static inputs, replay its graph and
        count its launches; returns a copy of what it returns."""
        g, statics, out, launches = self.graphs[key]
        _upload(inputs, self.device, statics)
        g.replay()
        for t, k, n in launches:
            t[k] = t.get(k, 0) + n
        self.replays += 1
        return None if out is None else type(out)(*(x.clone() for x in out))


def decode_chunk(
    params,
    cfg: PaDTConfig,
    state: DecodeState,
    n_steps: int,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    *,
    rec: Recorder,
    graphs: Graphs,
) -> DecodeState:
    """Advance every active slot up to `n_steps` tokens, in place; stops
    early when the pool drains (one `active.any()` readback per step).
    Token selection is `padt.sample_token` over each slot's own extended
    vocabulary (greedy by default, else from `state.generator`). Every
    step goes through `graphs` under one key: on the card the steps after
    the first replay one captured step.

    Host spans into `rec`: `decode.readback` for each `active.any()` wait
    (one a step, and one more where the pool drained before `n_steps`),
    `decode.step` for each step run (a replay, with the engine's `graphs`,
    or an eager step with the children `decode.logits` (logits, sampling,
    token bookkeeping, the new token's embedding), `decode.layers` (the
    text layers, each quantizing its new K/V rows) and `decode.store` (H6's
    store of every layer's rows)), and `decode.capture` for the capture."""
    sampling = (do_sample, temperature, top_k, top_p)

    def step(r: Recorder) -> None:
        with r.span("decode.step"):  # an eager step's span; a replay's is `graphs`'
            _plain_step(params, cfg, state, sampling, rec=r)

    for _ in range(n_steps):
        with rec.span("decode.readback"):
            if not bool(state.active.any()):
                break
        graphs("step", step, rec, generator=state.generator if do_sample else None)
        state.steps += 1
    return state


# ---------------------------------------------------------------------------
# Host-side engine: request queue -> slot scheduling -> results
# ---------------------------------------------------------------------------

@dataclass
class SharedPrefix:
    """A shareable prompt prefix (system preamble + image), prefilled once
    per `key` and KV-spliced into every slot that references it. `batch` is
    a one-row processor batch that ends at `<|vision_end|>`
    (`VisionTextProcessor.build_prefix_batch`); `rope_delta` is its M-RoPE
    delta. Requests carry the rest of their prompt in `suffix_ids`."""

    key: Any
    batch: Dict[str, Any]
    rope_delta: int


@dataclass
class Request:
    """One preprocessed request. `batch` leaves (numpy arrays or CPU tensors)
    have leading dim 1. Prefix-cached form: `prefix` + `suffix_ids` instead
    of `batch`. `expected_new_tokens` is a scheduling hint: it sizes decode
    chunks and never changes outputs."""

    batch: Optional[Dict[str, Any]] = None
    rope_delta: int = 0
    max_new_tokens: int = 0
    uid: Any = None
    prefix: Optional[SharedPrefix] = None
    suffix_ids: Optional[np.ndarray] = None
    expected_new_tokens: Optional[int] = None


@dataclass
class Completion:
    uid: Any
    tokens: Any  # (n_gen,) int array after the run; a device row before
    n_gen: int
    hidden: Optional[torch.Tensor] = None  # (T, D) on the device (collect_hidden=True)
    artifacts: Optional[Any] = None  # one-request VisionArtifacts (keep_artifacts=True)


@dataclass
class ServeStats:
    """One run's device seconds and counts. The prompt and patch counters
    are counted on the host from the request batches, over the rows of the
    prefill buckets, padding rows included (an admission of prefix-cached
    requests prefills only its uncached prefixes, and its suffix passes
    count as `suffix_passes`)."""

    prefill_s: float = 0.0  # device time of prefill + insert (+ suffix passes)
    decode_s: float = 0.0  # device time of the decode chunks
    generated_tokens: int = 0
    decode_steps: int = 0  # decode / verify forwards run
    suffix_passes: int = 0  # pool-wide K=32 suffix passes (prefix-cached admissions)
    completions: int = 0
    slot_step_utilization: float = 0.0  # generated / (steps * slots)
    graph_steps: int = 0  # decode steps run by replaying the engine's CUDA graph of a step (the capturing one too)
    graph_captures: int = 0  # captures of that graph (one per engine on the card)
    admit_graph_replays: int = 0  # `_admit` calls run by replaying the engine's graph of their bucket shape
    admit_graph_captures: int = 0  # captures of those graphs (one per bucket shape and engine on the card)
    # sparse experts (0 for a dense stack), summed on the device and read with the chunk's flags
    decode_expert_rows: int = 0  # token-expert choices of active slots, over layers and decode steps
    decode_experts_hit: int = 0  # (layer, expert) pairs with at least one of them, over decode steps
    prefill_expert_rows: int = 0  # choices of the prompt tokens of real requests (suffix passes too)
    prefill_experts_hit: int = 0
    moe_forwards: int = 0  # forwards through the expert layers: prefills, suffix passes, decode steps
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefill_tokens_saved: int = 0
    admissions: int = 0  # `_admit` / `_admit_prefix` calls
    prompt_tokens: int = 0  # real prompt tokens prefilled (attention-mask ones)
    prompt_slots: int = 0  # prefill bucket rows x prompt bucket
    patches: int = 0  # real patches through the tower
    patch_slots: int = 0  # prefill bucket rows x patch bucket

    def count_prefill(self, batches: List[Dict[str, Any]], rows: int) -> None:
        """Add a prefill bucket of `rows` rows whose real requests carry the
        host-side `batches` (one-row leaves)."""
        self.prompt_tokens += sum(int(np.asarray(b["attention_mask"]).sum()) for b in batches)
        self.prompt_slots += rows * np.shape(batches[0]["attention_mask"])[-1]
        if "num_patches" in batches[0]:
            self.patches += sum(int(np.asarray(b["num_patches"]).sum()) for b in batches)
            self.patch_slots += rows * np.shape(batches[0]["seg_full"])[-1]


def _mark(device: torch.device):
    """A point on the device's timeline: a recorded CUDA event on the card,
    the host clock on the CPU (where every op is synchronous)."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _span_s(a, b) -> float:
    """Seconds between two marks; events must have completed (read after a
    synchronizing readback)."""
    return b - a if isinstance(a, float) else a.elapsed_time(b) / 1e3


def _host_leaf(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def _pinned(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` in page-locked memory where `device` is the card (for `_upload`)."""
    return t.pin_memory() if device.type == "cuda" else t


def _stack_rows(name: str, rows: List[Any], device: torch.device) -> torch.Tensor:
    """One-row request leaves -> one batch tensor on the host (position_ids
    carries the 3 M-RoPE streams in dim 0 and the batch in dim 1), in
    page-locked memory where `device` is the card."""
    ts = [_host_leaf(x) for x in rows]
    shapes = {tuple(t.shape) for t in ts}
    if len(shapes) > 1:
        raise ValueError(
            f"request leaf {name!r} has mixed shapes {shapes}: requests in one admission "
            "bucket must share prompt/patch buckets (run() groups them by shape)"
        )
    dim = 1 if name == "position_ids" else 0
    shape = list(ts[0].shape)
    shape[dim] *= len(ts)
    return torch.cat(ts, dim=dim, out=torch.empty(shape, dtype=ts[0].dtype, pin_memory=device.type == "cuda"))


class RunCtx:
    """Per-run host bookkeeping for one engine (see ServeEngine.start_run)."""

    def __init__(self, rec: Recorder):
        self.pending: Dict[Any, deque] = {}
        self.n_pending = 0
        self.free: List[int] = []
        self.occupant: Dict[int, Request] = {}
        self.slot_art: Dict[int, Any] = {}
        self.results: List[Completion] = []
        self.stats = ServeStats()
        self.prev_n_gen = None
        self.rec = rec  # the run's host spans
        self.prefill_forwards = 0  # prefills and suffix passes run
        self.spans: List[Tuple[str, Any, Any]] = []  # (stat, start mark, end mark) not yet read
        # observed early-EOS completion lengths, for the chunk sizer's p90
        self.obs_lens: deque = deque(maxlen=256)


class ServeEngine:
    """Host scheduler around prefill / insert / decode_chunk.

    - `n_slots` decode slots share one int8 KV pool;
    - refills happen whenever >= `prefill_bucket` slots are free and requests
      are queued (buckets padded with budget-0 dummies), with smaller
      straggler buckets when fewer remain;
    - decode advances in chunks sized by the budget- and expectation-aware
      sizer; each chunk ends in one (B,) active / n_gen flag readback;
    - on the card a plain (not speculative) decode step replays the
      engine's graph of a step from the engine's second step on, and an
      admission of full-prompt requests replays the engine's graph of its
      bucket shape from the second admission of that shape on (`Graphs`;
      prefix-cached admissions run eagerly: their packs live on in the
      prefix cache).
    """

    def __init__(
        self,
        params,
        cfg: PaDTConfig,
        n_slots: int,
        max_new_tokens: int,
        prompt_len: int,
        prefill_bucket: int = 16,
        chunk_steps: int = 16,
        collect_hidden: bool = False,
        patch_bucket: Optional[int] = None,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        seed: int = 0,
        keep_artifacts: bool = False,
        prefill_bucket_small: Optional[int] = None,
        max_chunk_steps: Optional[int] = None,
        speculative: int = 0,
        suffix_bucket: int = _SUFFIX_K,  # prefix-cached requests' max suffix length
        prefix_cache_entries: int = 8,  # device-resident prefix-KV LRU size
        packed_weights: bool = True,  # fused qkv / gateup weight streams
    ):
        if packed_weights:
            params = padt_model.pack_inference_params(params)
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_new_tokens = max_new_tokens
        self.prefill_bucket = min(prefill_bucket, n_slots)
        self.prefill_bucket_small = min(prefill_bucket_small or max(1, self.prefill_bucket // 4), self.prefill_bucket)
        self.chunk_steps = chunk_steps
        self.max_chunk_steps = max_chunk_steps or 4 * chunk_steps
        self.collect_hidden = collect_hidden
        self.keep_artifacts = keep_artifacts
        if speculative and do_sample:
            raise ValueError("speculative decoding is greedy-only (exactness)")
        self.speculative = int(speculative)
        self.sampling = (do_sample, temperature, top_k, top_p)
        # a verify writes K rows past write_pos before acceptance is known:
        # K rows of headroom keep a slot at its last token off live rows
        cap = prompt_len + max_new_tokens + self.speculative
        self.capacity = -(-cap // 128) * 128
        self.moe = bool(text_opt(cfg.text, "num_experts"))
        if 0 < text_opt(cfg.text, "sa_topk") < self.capacity:
            raise ValueError(
                f"KV capacity {self.capacity} exceeds the {cfg.text.sa_topk} keys this model's sparse-attention "
                "indexer keeps: the indexer is not implemented, and dense attention would differ from the model"
            )
        embed = params["text"]["embed"]
        self.device = embed.device
        self.state = init_state(
            cfg, n_slots, self.capacity, max_new_tokens, embed.dtype, self.device,
            patch_bucket=patch_bucket, seed=seed,
        )
        self._decode_graphs = Graphs(1, self.device, "decode.capture", "decode.step")
        self._admit_graphs = Graphs(ADMISSION_GRAPHS, self.device, "admit.capture", "admit.graph")
        if suffix_bucket % _SUFFIX_K:
            raise ValueError(f"suffix_bucket must be a multiple of {_SUFFIX_K}")
        self.suffix_bucket = suffix_bucket
        self.prefix_cache_entries = prefix_cache_entries
        self._prefix_cache: Dict[Any, Tuple[PrefillPack, Any, int]] = {}  # insertion-ordered LRU

    def _prefill(self, rec: Recorder, batch, deltas, real_rows: torch.Tensor):
        tally = _tally(self.state, 1) if self.moe else None
        out = prefill(self.params, self.cfg, batch, deltas, self.capacity, return_artifacts=self.keep_artifacts,
                      rec=rec, real_rows=real_rows, tally=tally)
        return out if self.keep_artifacts else (out, None)

    def _admission(self, rec: Recorder, batch: Dict[str, torch.Tensor], rows: torch.Tensor):
        """An admission's device work on a bucket on the device (`rows`: its
        rows' rope deltas, slots and budgets): the tower, the prefill (with
        experts the tally of the rows with a budget: a padding row has
        none) and the insert into the slots. Returns the bucket's
        `VisionArtifacts` (None without `keep_artifacts`). The engine's
        admission graphs capture it."""
        deltas, slots, budgets = rows
        pack, art = self._prefill(rec, batch, deltas, budgets > 0)
        with rec.span("admit.insert"):
            insert(self.state, pack, slots, budgets)
        return art

    def _chunk(self, n: int, rec: Recorder):
        if self.speculative:
            decode_chunk_spec(self.params, self.cfg, self.state, n, self.speculative, rec=rec)
        else:
            decode_chunk(self.params, self.cfg, self.state, n, *self.sampling, rec=rec, graphs=self._decode_graphs)

    @staticmethod
    def _shape_key(req: Request):
        """Requests with equal leaf shapes share admission buckets; prefix-cached
        requests group by their prefix batch shapes."""
        if req.prefix is not None:
            if req.suffix_ids is None or len(req.suffix_ids) == 0:
                raise ValueError("prefix-cached requests need non-empty suffix_ids")
            return ("pfx",) + tuple(sorted((k, tuple(v.shape)) for k, v in req.prefix.batch.items()))
        if req.batch is None:
            raise ValueError("request needs either batch or prefix+suffix_ids")
        return tuple(sorted((k, tuple(v.shape)) for k, v in req.batch.items()))

    def _make_bucket(self, reqs: List[Any], slots: List[int], budgets: Optional[List[int]] = None):
        """An admission bucket on the host, page-locked on the card (for
        `_upload`): the leaves of `reqs` (requests, or shared prefixes)
        stacked and padded to len(slots) rows with copies of the first, and
        `_rows` of their rope deltas, the slots and the budgets (the
        requests' own where None)."""
        pad = len(slots) - len(reqs)
        stack = {k: _stack_rows(k, [q.batch[k] for q in reqs] + [reqs[0].batch[k]] * pad, self.device)
                 for k in reqs[0].batch}
        if budgets is None:
            budgets = [min(q.max_new_tokens, self.max_new_tokens) for q in reqs]
        return stack, self._rows([q.rope_delta for q in reqs], slots, budgets)

    def _rows(self, deltas: List[int], slots: List[int], budgets: List[int]) -> torch.Tensor:
        """A bucket's rows as one (3, R) int64 tensor, page-locked on the
        card: rope deltas, slots and budgets, each padded with 0 to
        R = len(slots) (a budget of 0 marks a padding row)."""
        pad = lambda v: list(v) + [0] * (len(slots) - len(v))
        return _pinned(torch.tensor([pad(deltas), slots, pad(budgets)], dtype=torch.int64), self.device)

    def start_run(self, requests: List[Request], schedule: str = "fifo", rec: Optional[Recorder] = None) -> RunCtx:
        """Order and group the requests and reset the per-run bookkeeping; `run`
        drives the returned context with `_refill` / `_dispatch_chunk` /
        `_sync_harvest` and ends with `_finish_run`. Host spans go to `rec`
        where the caller reads them, else to a recorder of this run alone."""
        if schedule == "longest_first":
            requests = sorted(requests, key=lambda q: -q.max_new_tokens)
        elif schedule != "fifo":
            raise ValueError(f"unknown schedule {schedule!r}")
        ctx = RunCtx(Recorder() if rec is None else rec)
        for q in requests:
            ctx.pending.setdefault(self._shape_key(q), deque()).append(q)
        ctx.n_pending = len(requests)
        ctx.free = list(range(self.n_slots))
        ctx.prev_n_gen = np.zeros(self.n_slots, np.int64)
        self.state.steps = 0
        self._decode_graphs.reset()
        self._admit_graphs.reset()
        self.state.moe_tally.zero_()
        return ctx

    def _sync_flags(self):
        """One readback per chunk: active flags and n_gen, and with experts
        the state's MoE tally (synchronizes the stream)."""
        st = self.state
        parts = [st.active.long(), st.n_gen] + ([st.moe_tally] if self.moe else [])
        both = torch.cat(parts).cpu().numpy()
        n = self.n_slots
        return both[:n].astype(bool), both[n : 2 * n], both[2 * n :], st.steps

    def _admit(self, ctx: RunCtx, grp: deque, r: int):
        """Admit up to r requests of one shape group as one bucket of r rows
        through the engine's admission graphs, keyed by the bucket's shape:
        eagerly, or by replaying the graph of that shape."""
        take = [grp.popleft() for _ in range(min(r, len(grp)))]
        ctx.n_pending -= len(take)
        slots = [ctx.free.pop() for _ in range(r)]
        rec = ctx.rec
        with rec.span("serve.admit"):
            with rec.span("admit.stack"):
                bucket = self._make_bucket(take, slots)
            t0 = _mark(self.device)
            art = self._admit_graphs((r, self._shape_key(take[0])), self._admission, rec, *bucket)
            ctx.prefill_forwards += 1
            ctx.spans.append(("prefill_s", t0, _mark(self.device)))
            ctx.stats.admissions += 1
            ctx.stats.count_prefill([q.batch for q in take], r)
            ctx.prev_n_gen[slots] = 0
            for i, q in enumerate(take):
                ctx.occupant[slots[i]] = q
                if art is not None:
                    ctx.slot_art[slots[i]] = type(art)(*(x[i : i + 1] for x in art))
            ctx.free.extend(slots[len(take):])  # padding slots go straight back

    def _admit_prefix(self, ctx: RunCtx, grp: deque, r: int):
        """Admit r prefix-cached requests: prefill only the uncached prefixes
        (one batched call), splice each request's prefix KV into its slot,
        then run all suffixes through the pool-wide K=32 suffix passes."""
        take = [grp.popleft() for _ in range(min(r, len(grp)))]
        ctx.n_pending -= len(take)
        for q in take:
            lp = q.prefix.batch["input_ids"].shape[1]
            s = len(q.suffix_ids)
            if s > self.suffix_bucket:
                raise ValueError(f"suffix length {s} exceeds suffix_bucket {self.suffix_bucket}")
            need = lp + -(-s // _SUFFIX_K) * _SUFFIX_K + min(q.max_new_tokens, self.max_new_tokens) + self.speculative
            if need > self.capacity:
                raise ValueError(
                    f"prefix {lp} + suffix {s} + budget does not fit capacity {self.capacity} "
                    f"(need {need}); raise prompt_len"
                )
        slots = [ctx.free.pop() for _ in range(r)]
        rec = ctx.rec
        with rec.span("serve.admit"):
            t0 = _mark(self.device)
            # 1) prefill the uncached prefixes, batched and padded to an engine bucket
            uniq, seen = [], set()
            for q in take:
                if q.prefix.key not in self._prefix_cache and q.prefix.key not in seen:
                    uniq.append(q.prefix)
                    seen.add(q.prefix.key)
            if uniq:
                with rec.span("admit.stack"):
                    ru = self.prefill_bucket_small if len(uniq) <= self.prefill_bucket_small else self.prefill_bucket
                    bucket = self._make_bucket(uniq, [0] * ru, [])  # a prefix row has no slot and no budget
                stack, rows = _upload(bucket, self.device)
                ctx.prefill_forwards += 1
                pack, art = self._prefill(rec, stack, rows[0], torch.arange(ru, device=self.device) < len(uniq))
                for i, p in enumerate(uniq):
                    plen = int(np.sum(np.asarray(p.batch["attention_mask"])))
                    arow = None if art is None else type(art)(*(x[i : i + 1] for x in art))
                    self._prefix_cache[p.key] = (_pack_slice(pack, i), arow, plen)
                ctx.stats.count_prefill([p.batch for p in uniq], ru)
            # per-request entries, popped and reinserted for LRU recency; the
            # local list keeps this admission's entries alive across the trim
            entries = []
            for q in take:
                e = self._prefix_cache.pop(q.prefix.key)
                self._prefix_cache[q.prefix.key] = e
                entries.append(e)
            while len(self._prefix_cache) > self.prefix_cache_entries:
                self._prefix_cache.pop(next(iter(self._prefix_cache)))
            ctx.stats.prefix_misses += len(uniq)
            ctx.stats.prefix_hits += len(take) - len(uniq)
            paying = {p.key for p in uniq}
            for q, e in zip(take, entries):
                if q.prefix.key in paying:
                    paying.discard(q.prefix.key)
                else:
                    ctx.stats.prefill_tokens_saved += e[2]
            # 2) splice the prefix KV into the slots
            pack = _pack_concat([e[0] for e in entries] + [entries[0][0]] * (r - len(take)))
            rows = _upload(self._rows([], slots, [min(q.max_new_tokens, self.max_new_tokens) for q in take]), self.device)
            with rec.span("admit.insert"):
                insert(self.state, pack, rows[1], rows[2])
            # 3) suffix passes over the pool (other slots' rows stay untouched)
            with rec.span("admit.suffix"):
                sfx = np.full((self.n_slots, self.suffix_bucket), self.cfg.pad_token_id, np.int64)
                slen = np.zeros(self.n_slots, np.int64)
                for i, q in enumerate(take):
                    ids = np.asarray(q.suffix_ids, np.int64).reshape(-1)
                    sfx[slots[i], : len(ids)] = ids
                    slen[slots[i]] = len(ids)
                sfx_t, slen_t = _upload(tuple(_pinned(torch.from_numpy(a), self.device) for a in (sfx, slen)), self.device)
                for c0 in range(0, self.suffix_bucket, _SUFFIX_K):
                    if not np.any(slen - c0 > 0):
                        break
                    _suffix_prefill_step(
                        self.params, self.cfg, self.state,
                        sfx_t[:, c0 : c0 + _SUFFIX_K], (slen_t - c0).clamp(0, _SUFFIX_K), rec=rec,
                    )
                    ctx.stats.suffix_passes += 1
                    ctx.prefill_forwards += 1
            ctx.spans.append(("prefill_s", t0, _mark(self.device)))
            ctx.stats.admissions += 1
            ctx.prev_n_gen[slots] = 0
            for i, q in enumerate(take):
                ctx.occupant[slots[i]] = q
                if entries[i][1] is not None:
                    ctx.slot_art[slots[i]] = entries[i][1]
            ctx.free.extend(slots[len(take):])

    def _refill(self, ctx: RunCtx):
        """Admit pending requests: full buckets first, then straggler (small)
        buckets, so freed slots never idle waiting for a full bucket."""
        progressed = True
        while ctx.n_pending and progressed:
            progressed = False
            for grp in sorted(ctx.pending.values(), key=len, reverse=True):
                if not grp:
                    continue
                admit = self._admit_prefix if grp[0].prefix is not None else self._admit
                if len(ctx.free) >= self.prefill_bucket and len(grp) >= self.prefill_bucket:
                    admit(ctx, grp, self.prefill_bucket)
                    progressed = True
                    break
                if len(ctx.free) >= self.prefill_bucket_small and (
                    len(grp) < self.prefill_bucket or len(ctx.free) < self.prefill_bucket
                ):
                    admit(ctx, grp, self.prefill_bucket_small)
                    progressed = True
                    break

    def _dispatch_chunk(self, ctx: RunCtx):
        """Run one decode chunk sized per slot by its remaining budget (device
        truth) or, earlier, its expected length (the request's hint, or once
        >= 8 uncensored lengths were seen, their p90), the minimum over slots
        clipped to [chunk_steps, max_chunk_steps]."""
        with ctx.rec.span("serve.decode_chunk"):
            est_default = int(np.percentile(list(ctx.obs_lens), 90)) if len(ctx.obs_lens) >= 8 else None
            remaining = []
            for s, q in ctx.occupant.items():
                n_gen = int(ctx.prev_n_gen[s])
                rem_budget = min(q.max_new_tokens, self.max_new_tokens) - n_gen
                est = q.expected_new_tokens if q.expected_new_tokens is not None else est_default
                rem = min(est - n_gen, rem_budget) if est is not None else rem_budget
                remaining.append(max(rem, 1))
            chunk_n = int(np.clip(min(remaining), self.chunk_steps, self.max_chunk_steps))
            t0 = _mark(self.device)
            self._chunk(chunk_n, ctx.rec)
            ctx.spans.append(("decode_s", t0, _mark(self.device)))

    def _sync_harvest(self, ctx: RunCtx):
        """Read the chunk's flags (the sync point), add the device spans that
        completed, and harvest the finished slots."""
        rec = ctx.rec
        with rec.span("serve.flag_readback"):
            active, n_gen, tally, steps_done = self._sync_flags()
        done = [s for s in ctx.occupant if not active[s]]
        with rec.span("serve.harvest"):
            for stat, a, b in ctx.spans:
                setattr(ctx.stats, stat, getattr(ctx.stats, stat) + _span_s(a, b))
            ctx.spans.clear()
            ctx.stats.decode_steps = steps_done
            ctx.stats.graph_steps, ctx.stats.graph_captures = self._decode_graphs.replays, self._decode_graphs.captures
            ctx.stats.admit_graph_replays, ctx.stats.admit_graph_captures = self._admit_graphs.replays, self._admit_graphs.captures
            if len(tally):
                st = ctx.stats
                st.decode_expert_rows, st.decode_experts_hit, st.prefill_expert_rows, st.prefill_experts_hit = (
                    int(v) for v in tally)
                st.moe_forwards = steps_done + ctx.prefill_forwards
            ctx.prev_n_gen = n_gen.copy()
            if not done:
                return
            # gathers copy the rows, so a refilled slot cannot clobber them
            with rec.span("harvest.readback"):  # a synchronous copy
                idx = torch.tensor(done, device=self.device)
            tok_rows = self.state.tokens[idx]
            hid_rows = self.state.hidden_out[idx] if self.collect_hidden else None
            for jd, s in enumerate(done):
                q = ctx.occupant.pop(s)
                ng = int(n_gen[s])
                # EOS strictly before the budget: an uncensored length observation
                if ng < min(q.max_new_tokens, self.max_new_tokens):
                    ctx.obs_lens.append(ng)
                ctx.results.append(Completion(
                    uid=q.uid, tokens=tok_rows[jd], n_gen=ng,
                    hidden=None if hid_rows is None else hid_rows[jd],
                    artifacts=ctx.slot_art.pop(s, None),
                ))
                ctx.stats.generated_tokens += ng
                ctx.stats.completions += 1
                ctx.free.append(s)

    def _finish_run(self, ctx: RunCtx) -> Tuple[List[Completion], ServeStats]:
        if ctx.results:
            with ctx.rec.span("tokens.readback"):
                all_tok = torch.stack([c.tokens for c in ctx.results]).cpu().numpy()
            for i, c in enumerate(ctx.results):
                c.tokens = all_tok[i, : c.n_gen].copy()
        if ctx.stats.decode_steps:
            ctx.stats.slot_step_utilization = ctx.stats.generated_tokens / (ctx.stats.decode_steps * self.n_slots)
        return ctx.results, ctx.stats

    def run(
        self, requests: List[Request], schedule: str = "fifo", rec: Optional[Recorder] = None,
    ) -> Tuple[List[Completion], ServeStats]:
        """Process `requests` to completion. schedule="longest_first" admits
        in descending max_new_tokens; per-request outputs are the same under
        any order (greedy decoding is prefix-stable, slots independent).
        Host spans go to `rec` as `start_run`'s, the whole run as
        `serve.run`."""
        ctx = self.start_run(requests, schedule, rec)
        with ctx.rec.span("serve.run"):
            while ctx.n_pending or ctx.occupant:
                self._refill(ctx)
                if not ctx.occupant:
                    break
                self._dispatch_chunk(ctx)
                self._sync_harvest(ctx)
            return self._finish_run(ctx)
