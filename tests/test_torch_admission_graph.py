"""The serve engine's CUDA graphs of an admission (its admission instance of
`serve.engine.Graphs`) against eager admissions, on the card.

These need an NVIDIA GPU with nvcc and skip elsewhere (on the CPU every
admission runs eagerly: `tests/test_torch_admission_cpu.py` holds that).
Run them on the card with `python -m pytest tests/test_torch_admission_graph.py -q`.

A replay runs the kernels the eager admission launches, on the same data,
so the decode state it leaves must equal the eager admission's bit for bit
(the KV rows and their scales, the slot bookkeeping, the carried hidden,
the prototype tables, and with experts the prefill tally), and so must
each slot's vision artifacts. The engine packs the tower (`gateup_w`), so
every replay runs H12 once per tower block; `tower3b` puts PaDT-3B's tower
(32 blocks, ff 3420 packed to 3424) on the tiny text stack."""

import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

from padt_tpu_torch import padt_3b, padt_tiny
from padt_tpu_torch.models import padt as P
from padt_tpu_torch.ops import launch_tallies
from padt_tpu_torch.preprocess.vision_process import ProcessedImage
from padt_tpu_torch.serve import Request, ServeEngine
from padt_tpu_torch.utils.mock_tokenizer import make_tiny_tokenizer
from padt_tpu_torch.utils.profiling import Recorder
from padt_tpu_torch.vrt.processor import VisionTextProcessor
from test_torch_moe import _moe_model

pytestmark = pytest.mark.cuda

PATCHES = 128
GRID = (1, 8, 12)
PROMPTS = ["detect the cat", "find a dog", "locate the car", "what is here", "segment it", 'find "a"']
# the DecodeState fields an admission writes
FIELDS = ("k8", "ks", "v8", "vs", "valid", "write_pos", "text_pos", "cur_hidden", "proto", "num_merged", "ctx",
          "ctx_len", "budget", "active", "n_gen", "moe_counts", "moe_tally")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _model(dev, kind):
    """padt_tiny in bf16 on the card (text-layer weights scaled up from the
    0.02 init), its int8-weight form, the tiny expert stack, or padt_tiny
    with PaDT-3B's tower (`tower3b`, its weights drawn on the card)."""
    if kind == "moe":
        return _moe_model(dev, torch.bfloat16)
    cfg = padt_tiny()
    if kind == "tower3b":
        cfg = cfg.replace(vision=dataclasses.replace(padt_3b().vision, out_hidden_size=cfg.text.hidden_size))
        p = P.init_padt_params(cfg, torch.Generator(device=dev).manual_seed(1), dev, torch.bfloat16)
        p["text"]["layers"] = {k: v * 5.0 if v.dim() == 3 else v for k, v in p["text"]["layers"].items()}
        return cfg, p
    p = P.init_padt_params(cfg, torch.Generator().manual_seed(1), "cpu", torch.float32)
    p["text"]["layers"] = {k: v * 5.0 if v.dim() == 3 else v for k, v in p["text"]["layers"].items()}
    to_dev = lambda t: {k: to_dev(v) for k, v in t.items()} if isinstance(t, dict) else t.to(dev, torch.bfloat16)
    p = to_dev(p)
    return cfg, P.quantize_params(p) if kind == "int8" else p


def _requests(cfg, n):
    proc = VisionTextProcessor(make_tiny_tokenizer(cfg), cfg, seq_bucket=32, patch_bucket=PATCHES)
    proc.prepare(cfg.text.vocab_size)
    img = lambda s: ProcessedImage(None, GRID, np.random.RandomState(s).randint(0, 256, (GRID[1] * GRID[2], 588)).astype(np.uint8))
    reqs = []
    for i in range(n):
        b = proc.build_batch([PROMPTS[i % len(PROMPTS)]], [img(i)], prompt_bucket=128, patch_bucket=PATCHES)
        reqs.append(Request(batch=b.data, rope_delta=int(b.rope_deltas[0]), max_new_tokens=4 + i, uid=i))
    return reqs


def _engine(cfg, params, graphs: bool):
    eng = ServeEngine(params, cfg, n_slots=8, max_new_tokens=12, prompt_len=128, prefill_bucket=2,
                      prefill_bucket_small=2, chunk_steps=4, patch_bucket=PATCHES, keep_artifacts=True)
    if not graphs:  # every admission eager, the engine otherwise the same
        eng._admit_graphs.limit = 0
    return eng


def _admit(eng, reqs):
    """One refill of an empty pool: seven requests in buckets of 2, the last
    with a padding row."""
    ctx = eng.start_run(reqs)
    eng._refill(ctx)
    eng._sync_harvest(ctx)  # the counters
    torch.cuda.synchronize()
    return ctx


def _hand_written(fn):
    """The port's own kernels (namespace `padt`) by name as a `torch.profiler`
    trace of `fn()` names them on the device."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return Counter(e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and "padt::" in e.name)


def _launched(fn):
    """Launches of `fn()` by (tally, key), as the kernel wrappers count them."""
    before = [dict(t) for t in launch_tallies()]
    fn()
    return {(i, k): n - b.get(k, 0) for i, (t, b) in enumerate(zip(launch_tallies(), before)) for k, n in t.items()
            if n != b.get(k, 0)}


@pytest.mark.parametrize("kind", ["bf16", "int8", "moe", "tower3b"])
def test_replayed_admissions_equal_eager(dev, kind):
    """Four admissions of one bucket shape into an empty pool: the first
    eager, the second captures and replays, the third and fourth replay
    (the fourth holds a padding row, whose slot stays idle and whose prompt
    the expert tally does not count). The pool and every slot's artifacts
    equal those of an engine that admits all four eagerly, bit for bit;
    the artifacts of the second admission survive the two replays after
    it. A second run replays all four. Under the profiler a replay names
    each hand-written kernel of an eager admission as many times, and the
    tallies count a replay's launches as an eager admission's: H12 once a
    tower block (32 with PaDT-3B's tower)."""
    cfg, params = _model(dev, kind)
    reqs = _requests(cfg, 7)
    eager = _engine(cfg, params, graphs=False)
    ce = _admit(eager, reqs)
    graphed = _engine(cfg, params, graphs=True)
    cg = _admit(graphed, reqs)
    st_e, st_g = ce.stats, cg.stats
    assert st_e.admissions == st_g.admissions == 4
    assert (st_e.admit_graph_replays, st_e.admit_graph_captures) == (0, 0)
    assert (st_g.admit_graph_replays, st_g.admit_graph_captures) == (3, 1)
    assert cg.rec.counts["admit.graph"] == 3 and cg.rec.counts["admit.capture"] == 1
    assert cg.rec.counts["admit.vision"] == cg.rec.counts["admit.prefill"] == 1  # the eager one
    assert sorted(cg.occupant) == sorted(ce.occupant) and len(cg.occupant) == 7 and cg.free == ce.free
    for f in FIELDS:
        assert torch.equal(getattr(graphed.state, f), getattr(eager.state, f)), f
    assert int(eager.state.active.sum()) == 7
    if kind == "moe":
        prompt = sum(int(np.asarray(q.batch["attention_mask"]).sum()) for q in reqs)
        kl = cfg.text.num_experts_per_tok * cfg.text.num_hidden_layers
        assert int(eager.state.moe_tally[2]) == prompt * kl  # the padding row is not counted
    for s in ce.occupant:
        for name, a, b in zip(ce.slot_art[s]._fields, cg.slot_art[s], ce.slot_art[s]):
            assert torch.equal(a, b), (s, name)

    cg2 = _admit(graphed, reqs)
    assert (cg2.stats.admit_graph_replays, cg2.stats.admit_graph_captures) == (4, 0)
    for f in FIELDS:  # the same admissions again (a run starts from a zero tally)
        assert torch.equal(getattr(graphed.state, f), getattr(eager.state, f)), f

    graphs = graphed._admit_graphs
    key = next(k for k, g in graphs.graphs.items() if g is not None)
    statics = graphs.graphs[key][1]  # the graph's static inputs, as the last replay left them
    replay_launches = _launched(lambda: graphs.replay(key))
    eager_launches = _launched(lambda: graphed._admission(Recorder(), *statics))
    replayed = _hand_written(lambda: graphs.replay(key))
    eager_kernels = _hand_written(lambda: graphed._admission(Recorder(), *statics))
    assert replayed == eager_kernels and sum(replayed.values()) > 0, (replayed, eager_kernels)
    named = lambda kernel: sum(n for k, n in replayed.items() if kernel in k)
    assert named("segment_flash_kernel") > 0 and named("window_slot_kernel") > 0  # H2, H3
    assert (named("expert_gemm_kernel") > 0) == (kind == "moe") and (named("gemm_kernel<true") > 0) == (kind == "int8")
    assert replay_launches == eager_launches and replay_launches
    assert [n for (_, k), n in replay_launches.items() if k == "swiglu"] == [cfg.vision.depth]
    assert named("swiglu_kernel") == cfg.vision.depth


def test_artifacts_outlive_later_replays(dev):
    """A slot's artifacts are copies: replaying the bucket's graph for other
    slots, on other images, leaves them as they were."""
    cfg, params = _model(dev, "bf16")
    reqs = _requests(cfg, 7)
    eng = _engine(cfg, params, graphs=True)
    ctx = _admit(eng, reqs)
    kept = {s: [x.clone() for x in a] for s, a in ctx.slot_art.items()}
    ctx2 = eng.start_run(_requests(cfg, 9)[7:])  # two requests on new images: one bucket
    eng._refill(ctx2)
    torch.cuda.synchronize()
    assert eng._admit_graphs.replays == 1 and set(ctx2.occupant) < set(ctx.slot_art)
    for s, a in ctx.slot_art.items():
        for x, y in zip(a, kept[s]):
            assert torch.equal(x, y), s
