"""PyTorch port serve engine (`padt_tpu_torch.serve`) and `run_stream` vs the
JAX ones on the CPU (padt_tiny, float32, seeded inputs), mirroring
tests/test_serve.py.

Greedy tokens, counts and the engines' step counters must be equal. Hidden
states: within 1e-3 relative to their magnitude. Both sides run float32
with an int8 KV cache; an int8 value may differ by one quantum where the
two frameworks' float32 sums round a product to either side of a rounding
boundary, and that moves the hidden states by far less than this."""

import dataclasses
from collections import deque

import numpy as np

import jax
import pytest
import torch

from test_torch_common import close, port_image, seeded_image, tiny_params, tiny_processor, torch_cfg
from padt_tpu.eval.harness import InferenceEngine as JaxEngine
from padt_tpu.models import padt as JP
from padt_tpu.serve import Request as JRequest
from padt_tpu.serve import ServeEngine as JServe
from padt_tpu.serve import SharedPrefix as JPrefix
from padt_tpu_torch.convert.from_jax import params_from_numpy
from padt_tpu_torch.eval.harness import InferenceEngine
from padt_tpu_torch.models import padt as TP
from padt_tpu_torch.serve import Request, ServeEngine, SharedPrefix
from padt_tpu_torch.serve import engine as S
from padt_tpu_torch.utils import profiling

HID_TOL = 1e-3
PATCHES = 128  # patch bucket of every batch below (8x12-patch images)


def _params(text_scale=5.0, proto_ln=False):
    """Tiny params; text-layer weights scaled up from the 0.02 init so the
    model emits varied tokens (and, with proto_ln, VRT objects)."""
    cfg, jp, _ = tiny_params(0)
    jp["text"]["layers"] = jax.tree.map(lambda x: x * text_scale if x.ndim == 3 else x, jp["text"]["layers"])
    if proto_ln:
        jp["proto"]["ln_w"] = jax.numpy.ones_like(jp["proto"]["ln_w"])
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _batches(cfg, proc, prompts, seed, grid=(1, 8, 12), prompt_bucket=128):
    return [
        proc.build_batch([p], [seeded_image(grid, seed + i, u8=False)], prompt_bucket=prompt_bucket, patch_bucket=PATCHES)
        for i, p in enumerate(prompts)
    ]


def _requests(batches, budgets, pair=(JRequest, Request)):
    """The same requests for both engines."""
    return tuple(
        [R(batch=b.data, rope_delta=int(b.rope_deltas[0]), max_new_tokens=bud, uid=i) for i, (b, bud) in enumerate(zip(batches, budgets))]
        for R in pair
    )


def _by_uid(results):
    return {c.uid: c for c in results}


def _same_completions(jres, tres, hidden=True):
    j, t = _by_uid(jres), _by_uid(tres)
    assert set(j) == set(t)
    for uid in j:
        assert t[uid].n_gen == j[uid].n_gen, uid
        np.testing.assert_array_equal(t[uid].tokens, np.asarray(j[uid].tokens), err_msg=f"req {uid}")
        if hidden:
            n = j[uid].n_gen
            close(t[uid].hidden[:n], np.asarray(j[uid].hidden, np.float32)[:n], tol=HID_TOL)


def _engines(cfg, jp, tp, **kw):
    return JServe(jp, cfg, **kw), ServeEngine(tp, torch_cfg(cfg), **kw)


def test_engine_matches_generate_with_recycling():
    """5 ragged requests through a 3-slot pool (bucket 1, chunk 2): several
    insert -> decode -> harvest -> refill cycles. Every completion equals the
    JAX engine's and the port's own int8 `generate`; the step counters agree."""
    cfg, jp, tp = _params()
    proc = tiny_processor(cfg)
    batches = _batches(cfg, proc, ["detect the cat", "find a dog", "locate the car", "what is here", "segment it"], 0)
    budgets = [4, 9, 3, 8, 6]
    kw = dict(n_slots=3, max_new_tokens=12, prompt_len=128, prefill_bucket=1, chunk_steps=2, collect_hidden=True, patch_bucket=PATCHES)
    jeng, teng = _engines(cfg, jp, tp, **kw)
    jreqs, treqs = _requests(batches, budgets)
    jres, jstats = jeng.run(jreqs)
    tres, tstats = teng.run(treqs)
    _same_completions(jres, tres)
    assert len({len(c.tokens) for c in tres}) > 1 and any(len(set(c.tokens.tolist())) > 2 for c in tres)
    assert (tstats.completions, tstats.generated_tokens, tstats.decode_steps) == (
        jstats.completions, jstats.generated_tokens, jstats.decode_steps,
    )
    assert 0 < tstats.slot_step_utilization <= 1.0
    assert tstats.prefill_s > 0 and tstats.decode_s > 0

    by = _by_uid(tres)
    for i, (b, bud) in enumerate(zip(batches, budgets)):
        tb = {k: torch.as_tensor(np.asarray(v)) for k, v in b.data.items()}
        out = TP.generate(tp, torch_cfg(cfg), tb, bud, torch.as_tensor(b.rope_deltas), kv_cache_dtype="int8")
        ng = int(out.num_generated[0])
        assert by[i].n_gen == ng
        np.testing.assert_array_equal(by[i].tokens, out.tokens[0, :ng].numpy())
        close(by[i].hidden[:ng], out.hidden[0, :ng].numpy(), tol=HID_TOL)

    # longest-first admission: the same per-request outputs
    tres2, _ = teng.run(treqs, schedule="longest_first")
    for c in tres2:
        np.testing.assert_array_equal(c.tokens, by[c.uid].tokens)


def test_engine_bucket_padding_and_idle_slots():
    """Bucket 2 with 3 requests: the last refill pads with a budget-0 dummy
    whose slot comes back free without a completion."""
    cfg, jp, tp = _params()
    proc = tiny_processor(cfg)
    batches = _batches(cfg, proc, ["find a dog", "what is here", "segment it"], 7)
    kw = dict(n_slots=4, max_new_tokens=8, prompt_len=128, prefill_bucket=2, chunk_steps=3, patch_bucket=PATCHES)
    jeng, teng = _engines(cfg, jp, tp, **kw)
    jreqs, treqs = _requests(batches, [5, 5, 5])
    jres, _ = jeng.run(jreqs)
    tres, tstats = teng.run(treqs)
    assert tstats.completions == 3 and sorted(c.uid for c in tres) == [0, 1, 2]
    for c in tres:
        assert c.n_gen <= 5 and len(c.tokens) == c.n_gen
    _same_completions(jres, tres, hidden=False)


def _chunk_log(eng):
    """(steps asked, steps run) of every decode chunk the engine runs."""
    log, orig = [], eng._chunk

    def chunk(n, rec=None):
        s0 = eng.state.steps
        orig(n, rec)
        log.append((n, eng.state.steps - s0))

    eng._chunk = chunk
    return log


@pytest.mark.parametrize("speculative", [0, 3])
def test_engine_spans_and_counters(speculative):
    """With the span list recorded: one `decode.step` per decode step, one
    `decode.readback` per step plus one for each chunk whose pool drained
    before its end, every span inside its parent, no `.readback` span in an
    admission (its copies to the device do not wait), the admission counters equal to
    counts made from the requests (a budget-0 dummy row included), and the
    completions the JAX engine's. Without tracing the
    same run keeps the same sums and counts and no list."""
    cfg, jp, tp = _params()
    proc = tiny_processor(cfg)
    batches = _batches(cfg, proc, ["detect the cat", "find a dog", "segment it"], 31)
    kw = dict(n_slots=4, max_new_tokens=8, prompt_len=128, prefill_bucket=2, prefill_bucket_small=2, chunk_steps=2,
              patch_bucket=PATCHES, speculative=speculative)
    jeng, teng = _engines(cfg, jp, tp, **kw)
    jreqs, treqs = _requests(batches, [6, 3, 5])
    jres, _ = jeng.run(jreqs)
    log = _chunk_log(teng)
    rec = profiling.Recorder()
    with profiling.recording():
        tres, st = teng.run(treqs, rec=rec)
    _same_completions(jres, tres, hidden=False)

    n = rec.counts
    assert n["decode.step"] == st.decode_steps > 0
    assert any(done < asked for asked, done in log)  # a chunk that ended early
    assert n["decode.readback"] == sum(done + (done < asked) for asked, done in log)
    assert n["serve.decode_chunk"] == n["serve.flag_readback"] == n["serve.harvest"] == len(log)
    assert n["decode.layers"] == n["decode.store"] == st.decode_steps
    assert n["decode.logits"] == st.decode_steps * (2 if speculative else 1)
    assert n.get("decode.emit.readback", 0) == (st.decode_steps if speculative else 0)
    assert n["serve.run"] == n["tokens.readback"] == 1
    assert n["serve.admit"] == n["admit.stack"] == n["admit.vision"] == n["admit.prefill"] == n["admit.insert"] == 2
    assert "admit.graph" not in n and "admit.capture" not in n  # the CPU admits eagerly
    assert 1 <= n["harvest.readback"] <= 3  # a harvest of at least one of the 3 requests
    spans = rec.spans

    def under_admit(i):
        while i >= 0 and spans[i][0] != "serve.admit":
            i = spans[i][3]
        return i >= 0

    # every upload of an admission is a copy that does not wait: no `.readback` span under `serve.admit`
    assert not [s[0] for i, s in enumerate(spans) if s[0].endswith(".readback") and under_admit(i)]
    assert spans[0][0] == "serve.run" and spans[0][3] == -1
    want_parent = {"serve": "serve.run", "tokens": "serve.run", "admit": "serve.admit", "decode": "decode.step",
                   "harvest": "serve.harvest"}
    want_parent.update({"decode.step": "serve.decode_chunk", "decode.readback": "serve.decode_chunk",
                        "decode.emit.readback": "decode.logits"})
    for i, (name, t0, t1, parent) in enumerate(spans[1:], 1):
        assert 0 <= parent < i and spans[parent][1] <= t0 <= t1 <= spans[parent][2], (name, parent)
        assert spans[parent][0] == want_parent.get(name, want_parent[name.split(".")[0]]), name
    for name, total in rec.sums.items():
        assert total == sum(t1 - t0 for s, t0, t1, _ in spans if s == name)

    # the counters, by hand from the requests: buckets of 2 rows, the second with one dummy
    real = [b.data for b in batches]
    assert st.admissions == 2
    assert st.prompt_tokens == sum(int(d["attention_mask"].sum()) for d in real) and st.prompt_slots == 4 * 128
    assert st.patches == sum(int(d["num_patches"].sum()) for d in real) and st.patch_slots == 4 * PATCHES
    assert st.patches < st.patch_slots and st.prompt_tokens < st.prompt_slots

    off = profiling.Recorder()
    tres2, st2 = teng.run(treqs, rec=off)
    assert off.spans is None and off.counts == rec.counts and st2 == st.__class__(**{**vars(st), **{
        k: getattr(st2, k) for k in ("prefill_s", "decode_s")}})
    _same_completions(jres, tres2, hidden=False)


def test_engine_speculative_matches_plain():
    """speculative=4 (prompt-lookup drafts + 4-token verify through H5) is
    token-identical to plain greedy decoding, and to the JAX speculative
    engine, with the same number of verify forwards."""
    cfg, jp, tp = _params()
    proc = tiny_processor(cfg)
    batches = _batches(cfg, proc, ["detect the cat", "find a dog", "locate the car", "what is here"], 13)
    budgets = [6, 11, 4, 9]
    kw = dict(n_slots=2, max_new_tokens=12, prompt_len=128, prefill_bucket=1, chunk_steps=3, patch_bucket=PATCHES, collect_hidden=True)
    jreqs, treqs = _requests(batches, budgets)
    plain, _ = ServeEngine(tp, torch_cfg(cfg), **kw).run(treqs)
    spec, sstats = ServeEngine(tp, torch_cfg(cfg), speculative=4, **kw).run(treqs)
    jspec, jstats = JServe(jp, cfg, speculative=4, **kw).run(jreqs)
    p = _by_uid(plain)
    for c in spec:
        assert c.n_gen == p[c.uid].n_gen
        np.testing.assert_array_equal(c.tokens, p[c.uid].tokens)
        close(c.hidden[: c.n_gen], p[c.uid].hidden[: c.n_gen].numpy(), tol=HID_TOL)
    _same_completions(jspec, spec)
    assert sstats.generated_tokens == sum(c.n_gen for c in spec)
    assert sstats.decode_steps == jstats.decode_steps


def _prefix_setup(cfg, proc, img_seeds, prefix_bucket):
    imgs = [seeded_image((1, 8, 12), s, u8=False) for s in img_seeds]
    pbs = [proc.build_prefix_batch(im, prefix_bucket=prefix_bucket, patch_bucket=PATCHES) for im in imgs]
    return imgs, pbs


def test_prefix_cache_matches_full_prefill():
    """Prefix KV caching: 6 requests over 2 images through a recycling pool;
    the first request of each image pays one prefix prefill, the others
    reuse it and run only their suffix (H5 suffix passes over slots that are
    mid-decode). Same tokens as full-prompt prefill and as the JAX prefix
    engine, same cache accounting; a second run is all hits."""
    cfg, jp, tp = _params()
    proc = tiny_processor(cfg)
    prompts = ["detect the cat", "find a dog", "locate it", "what is here", "segment it", "find a car"]
    img_of = [0, 0, 1, 0, 1, 1]
    budgets = [4, 9, 3, 8, 6, 5]
    imgs, pbs = _prefix_setup(cfg, proc, (5, 6), 96)
    full = [proc.build_batch([p], [imgs[img_of[i]]], prompt_bucket=128, patch_bucket=PATCHES) for i, p in enumerate(prompts)]
    suffixes = [np.asarray(proc.build_suffix_ids(p), np.int32) for p in prompts]
    kw = dict(n_slots=3, max_new_tokens=12, prompt_len=128, prefill_bucket=2, prefill_bucket_small=1, chunk_steps=2,
              patch_bucket=PATCHES, collect_hidden=True)

    def prefix_reqs(R, P):
        pre = [P(key=j, batch=pbs[j].data, rope_delta=int(pbs[j].rope_deltas[0])) for j in range(2)]
        return [R(prefix=pre[img_of[i]], suffix_ids=suffixes[i], max_new_tokens=budgets[i], uid=i) for i in range(len(prompts))]

    _, treqs_full = _requests(full, budgets)
    tfull, _ = ServeEngine(tp, torch_cfg(cfg), **kw).run(treqs_full)
    teng = ServeEngine(tp, torch_cfg(cfg), **kw)
    treqs = prefix_reqs(Request, SharedPrefix)
    tpfx, stats = teng.run(treqs)
    jpfx, jstats = JServe(jp, cfg, **kw).run(prefix_reqs(JRequest, JPrefix))
    f = _by_uid(tfull)
    for c in tpfx:
        assert c.n_gen == f[c.uid].n_gen
        np.testing.assert_array_equal(c.tokens, f[c.uid].tokens, err_msg=f"req {c.uid}")
    _same_completions(jpfx, tpfx)
    plen = int(np.sum(pbs[0].data["attention_mask"]))
    assert (stats.prefix_misses, stats.prefix_hits, stats.prefill_tokens_saved) == (2, 4, 4 * plen)
    assert (jstats.prefix_misses, jstats.prefix_hits) == (2, 4)
    assert stats.suffix_passes >= 3  # one per admission (every suffix < 32 tokens), 6 requests in buckets of <= 2
    again, stats2 = teng.run(treqs)
    assert (stats2.prefix_misses, stats2.prefix_hits) == (0, len(prompts))
    for c in again:
        np.testing.assert_array_equal(c.tokens, _by_uid(tpfx)[c.uid].tokens)


def test_suffix_pass_never_touches_other_slots_kv():
    """A pool-wide suffix pass next to a near-capacity live slot: capacity 128,
    so the pass's clamped store position (128 - 32 = 96) lands on slot A's
    live rows once A has decoded past row 96. H6 must write none of A's
    bytes (n_rows 0), and A's tokens must equal a solo run and the JAX
    engine's run of the same sequence of admissions."""
    cfg, jp, tp = _params()
    proc = tiny_processor(cfg)
    img = seeded_image((1, 4, 8), 11, u8=False)
    fa = proc.build_batch(["find the very sneaky cat"], [img], prompt_bucket=96, patch_bucket=PATCHES)
    pb = proc.build_prefix_batch(img, prefix_bucket=64, patch_bucket=PATCHES)
    sfx = np.asarray(proc.build_suffix_ids("segment it"), np.int32)
    kw = dict(n_slots=2, max_new_tokens=32, prompt_len=96, prefill_bucket=1, prefill_bucket_small=1, chunk_steps=4, patch_bucket=PATCHES)

    def drive(eng, R, P, check_bytes):
        req_a = R(batch=fa.data, rope_delta=int(fa.rope_deltas[0]), max_new_tokens=32, uid=0)
        req_b = R(prefix=P(key=7, batch=pb.data, rope_delta=int(pb.rope_deltas[0])), suffix_ids=sfx, max_new_tokens=8, uid=1)
        assert eng.capacity == 128
        ctx = eng.start_run([req_a])
        eng._refill(ctx)
        eng._dispatch_chunk(ctx)
        eng._sync_harvest(ctx)
        (slot_a,) = ctx.occupant.keys()
        wp = int(np.asarray(eng.state.write_pos)[slot_a])
        assert wp > 96, "slot A must be past the clamp boundary"
        snap = {k: np.array(getattr(eng.state, k)[:, slot_a, :, :wp]) for k in ("k8", "v8", "ks", "vs")}
        eng._admit_prefix(ctx, deque([req_b]), 1)
        if check_bytes:
            for k, before in snap.items():
                np.testing.assert_array_equal(getattr(eng.state, k)[:, slot_a, :, :wp].numpy(), before, err_msg=k)
        while ctx.n_pending or ctx.occupant:
            eng._refill(ctx)
            if not ctx.occupant:
                break
            eng._dispatch_chunk(ctx)
            eng._sync_harvest(ctx)
        comps, _ = eng._finish_run(ctx)
        solo, _ = type(eng)(eng.params, eng.cfg, **kw).run([req_a])
        return _by_uid(comps), solo[0]

    t, tsolo = drive(ServeEngine(tp, torch_cfg(cfg), **kw), Request, SharedPrefix, True)
    j, _ = drive(JServe(jp, cfg, **kw), JRequest, JPrefix, False)
    np.testing.assert_array_equal(t[0].tokens, tsolo.tokens)
    for uid in (0, 1):
        np.testing.assert_array_equal(t[uid].tokens, np.asarray(j[uid].tokens))


def _state_ptrs(state):
    return {f.name: getattr(state, f.name).data_ptr() for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)}


@pytest.mark.parametrize("speculative", [0, 3])
def test_decode_state_keeps_its_tensors(monkeypatch, speculative):
    """A CUDA graph of a decode step replays fixed addresses, so every path
    writes the decode state in place: each `DecodeState` tensor keeps its
    `data_ptr()` through every `insert`, every decode chunk (plain chunks
    that drain the pool mid-chunk, or speculative ones) and every suffix pass
    of a prefix admission, over a run of full-prompt and prefix-cached
    requests. On the CPU no step is graphed."""
    cfg, jp, tp = _params()
    proc = tiny_processor(cfg)
    tcfg = torch_cfg(cfg)
    full = _batches(cfg, proc, ["detect the cat", "find a dog", "locate the car"], 3)
    imgs, pbs = _prefix_setup(cfg, proc, (5, 6), 96)
    kw = dict(n_slots=3, max_new_tokens=12, prompt_len=128, prefill_bucket=2, prefill_bucket_small=1, chunk_steps=4,
              patch_bucket=PATCHES, speculative=speculative)
    eng = ServeEngine(tp, tcfg, **kw)
    want = _state_ptrs(eng.state)
    seen = {"insert": 0, "chunk": 0, "suffix": 0, "drained": 0}

    def held(kind):
        assert _state_ptrs(eng.state) == want, kind
        seen[kind] += 1

    for name, kind in (("insert", "insert"), ("_suffix_prefill_step", "suffix")):
        orig = getattr(S, name)
        monkeypatch.setattr(S, name, lambda *a, _o=orig, _k=kind, **k: (_o(*a, **k), held(_k))[0])
    chunk = eng._chunk

    def checked_chunk(n, rec):
        s0 = eng.state.steps
        chunk(n, rec)
        seen["drained"] += eng.state.steps - s0 < n  # the pool drained mid-chunk
        held("chunk")

    eng._chunk = checked_chunk
    _, treqs = _requests(full, [5, 9, 3])
    pre = [SharedPrefix(key=j, batch=pbs[j].data, rope_delta=int(pbs[j].rope_deltas[0])) for j in range(2)]
    treqs += [Request(prefix=pre[j % 2], suffix_ids=np.asarray(proc.build_suffix_ids(p), np.int32), max_new_tokens=b, uid=10 + j)
              for j, (p, b) in enumerate(zip(["what is here", "segment it", "find a car"], [4, 7, 2]))]
    res, st = eng.run(treqs)
    assert len(res) == 6 and seen["insert"] >= 3 and seen["suffix"] >= 1 and seen["chunk"] >= 3 and seen["drained"]
    assert _state_ptrs(eng.state) == want
    assert st.decode_steps > 0 and st.graph_steps == st.graph_captures == 0


def test_run_stream_matches_jax_and_run_batch():
    """InferenceEngine.run_stream (serve engine, per-request artifacts ->
    vl_decode), plain and share_prefix, vs the JAX harness's run_stream:
    the same completions, objects and boxes. The port's run_batch, which
    then runs on the engine's packed weights, gives the same completions."""
    cfg, jp, tp = _params(proto_ln=True)
    uniq = [seeded_image((1, 8, 12), 17 + i, u8=False) for i in range(2)]
    images = [uniq[0], uniq[0], uniq[1], uniq[0], uniq[1]]
    prompts = ['find "a"', 'find "b"', 'find "c"', "what is it", "segment it"]
    sizes = [(181, 117)] * len(images)
    kw = dict(n_slots=2, prefill_bucket=1, chunk_steps=3, patch_bucket=PATCHES)
    jeng = JaxEngine(jp, cfg, tiny_processor(cfg), max_new_tokens=8, canvas_hw=(9, 9), compact_pixels=False)
    tcfg = torch_cfg(cfg)
    teng = InferenceEngine(tp, tcfg, tiny_processor(tcfg), max_new_tokens=8, canvas_hw=(9, 9), compact_pixels=False)
    timages = [port_image(im) for im in images]
    for share in (False, True):
        extra = {} if share else {"prompt_bucket": 128}
        jgot = jeng.run_stream(prompts, images, image_sizes=sizes, share_prefix=share, **kw, **extra)
        tgot = teng.run_stream(prompts, timages, image_sizes=sizes, share_prefix=share, **kw, **extra)
        assert [r.completion for r in tgot] == [r.completion for r in jgot]
        for tr, jr in zip(tgot, jgot):
            assert [(o.label, o.vrt_string, o.bbox_xywh_px) for o in tr.objects] == [
                (o.label, o.vrt_string, o.bbox_xywh_px) for o in jr.objects
            ]
        if not share:
            plain = tgot
    assert sum(len(r.objects) for r in plain) > 0
    assert "qkv_w" in teng.params["text"]["layers"]  # adopted from the serve engine
    ref = teng.run_batch(prompts, timages, image_sizes=sizes, patch_bucket=PATCHES, prompt_bucket=128)
    assert [r.completion for r in ref] == [r.completion for r in plain]
    split = teng.pop_stream_stats()
    assert split["generated_tokens"] > 0 and split["engine_decode_s"] > 0
    assert split["decode_steps"] > 0 and split["suffix_passes"] > 0  # the share_prefix run's suffix passes


def test_engine_on_int8_weights_matches_jax():
    """The serve engine on int8 packed text-layer weights (each side
    quantized by its own `quantize_params`; the engine packs them): 5 ragged
    requests through a recycling 3-slot pool give the JAX engine's tokens,
    counts and step counters."""
    cfg, jp, tp = _params()
    jq, tq = JP.quantize_params(jp), TP.quantize_params(tp)
    proc = tiny_processor(cfg)
    batches = _batches(cfg, proc, ["detect the cat", "find a dog", "locate the car", "what is here", "segment it"], 21)
    budgets = [4, 9, 3, 8, 6]
    kw = dict(n_slots=3, max_new_tokens=12, prompt_len=128, prefill_bucket=1, chunk_steps=2, collect_hidden=True, patch_bucket=PATCHES)
    jeng, teng = _engines(cfg, jq, tq, **kw)
    assert "qkv_w_q" in teng.params["text"]["layers"] and "gateup_w_s" in teng.params["text"]["layers"]
    jreqs, treqs = _requests(batches, budgets)
    jres, jstats = jeng.run(jreqs)
    tres, tstats = teng.run(treqs)
    _same_completions(jres, tres)
    assert any(len(set(c.tokens.tolist())) > 2 for c in tres)
    assert (tstats.completions, tstats.generated_tokens, tstats.decode_steps) == (
        jstats.completions, jstats.generated_tokens, jstats.decode_steps,
    )


def test_run_batch_and_run_stream_on_quantized_init():
    """The 7B path's entry points at the tiny size: params straight from
    `init_padt_params_quantized(packed=True)`, then `run_batch` (bf16 KV)
    and `run_stream` (int8 KV) on them, well-formed results of every
    request; run_stream leaves the weights as they were (already packed)."""
    cfg = torch_cfg(tiny_params(0)[0])
    params = TP.init_padt_params_quantized(cfg, torch.Generator().manual_seed(3), "cpu", torch.float32, packed=True)
    images = [port_image(seeded_image((1, 8, 12), 40 + i, u8=False)) for i in range(5)]
    prompts = ['find "a"', 'find "b"', "what is it", 'where is "c"', "segment it"]
    teng = InferenceEngine(params, cfg, tiny_processor(cfg), max_new_tokens=6, canvas_hw=(9, 9), compact_pixels=False)
    batch = teng.run_batch(prompts[:2], images[:2], patch_bucket=PATCHES, prompt_bucket=128)
    stream = teng.run_stream(prompts, images, n_slots=2, prefill_bucket=2, chunk_steps=3, patch_bucket=PATCHES, prompt_bucket=128)
    assert len(batch) == 2 and len(stream) == 5 and all(isinstance(r.completion, str) for r in batch + stream)
    assert teng.params["text"]["layers"] is params["text"]["layers"]
    stats = teng.pop_stream_stats()
    assert stats["generated_tokens"] >= 5 and stats["decode_steps"] > 0
    # the host split: span sums under the stats' keys, the counters, no span list without tracing
    assert stats["run_s"] == stats["host_s"]["serve.run"] > 0 and stats["host_n"]["serve.run"] == 1
    assert stats["tail_s"] == stats["host_s"]["stream.tail"] and stats["build_s"] == stats["host_s"]["stream.build"]
    assert stats["host_n"]["decode.step"] == stats["decode_steps"] and "spans" not in stats
    assert stats["admissions"] == 3  # buckets 2, 2, 1
    assert stats["prompt_slots"] == 5 * 128 and stats["patch_slots"] == 5 * PATCHES
    with profiling.recording():
        teng.run_stream(prompts[:2], images[:2], n_slots=2, prefill_bucket=2, chunk_steps=3, patch_bucket=PATCHES,
                        prompt_bucket=128)
    stats = teng.pop_stream_stats()
    names = [s[0] for s in stats["spans"]]
    assert names[:2] == ["stream.build", "serve.run"] and names[-1] == "stream.tail"
    assert teng.pop_stream_stats() is None
