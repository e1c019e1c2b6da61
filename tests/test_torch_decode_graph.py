"""The serve engine's CUDA graph of a decode step (its decode instance of
`serve.engine.Graphs`) against eager decode steps, on the card.

These need an NVIDIA GPU with nvcc and skip elsewhere (on the CPU no step
is graphed: `tests/test_torch_serve.py` holds that). Run them on the card
with `python -m pytest tests/test_torch_decode_graph.py -q`.

The replay runs the kernels the eager step launches, on the same data, so
tokens must be equal, greedy or sampled from one seed (a replay draws from
the generator's offset as it then stands and moves it on as the eager step
does); hidden states are held to the serve tests' tolerance (1e-3 of their
magnitude)."""

from collections import Counter

import numpy as np
import pytest
import torch

from padt_tpu_torch import padt_tiny
from padt_tpu_torch.models import padt as P
from padt_tpu_torch.ops import launch_tallies
from padt_tpu_torch.preprocess.vision_process import ProcessedImage
from padt_tpu_torch.serve import Request, ServeEngine, SharedPrefix
from padt_tpu_torch.serve import engine as S
from padt_tpu_torch.utils.mock_tokenizer import make_tiny_tokenizer
from padt_tpu_torch.utils.profiling import Recorder
from padt_tpu_torch.vrt.processor import VisionTextProcessor

pytestmark = pytest.mark.cuda

HID_TOL = 1e-3  # tests/test_torch_serve.py's
PATCHES = 128
GRID = (1, 8, 12)
PROMPTS = ["detect the cat", "find a dog", "locate the car", "what is here", "segment it", 'find "a"']


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _model(dev, weights):
    """padt_tiny in bf16 on the card, text-layer weights scaled up from the
    0.02 init so the model emits varied tokens; int8: quantized on the card."""
    cfg = padt_tiny()
    p = P.init_padt_params(cfg, torch.Generator().manual_seed(1), "cpu", torch.float32)
    p["text"]["layers"] = {k: v * 5.0 if v.dim() == 3 else v for k, v in p["text"]["layers"].items()}
    to_dev = lambda t: {k: to_dev(v) for k, v in t.items()} if isinstance(t, dict) else t.to(dev, torch.bfloat16)
    p = to_dev(p)
    return cfg, P.quantize_params(p) if weights == "int8" else p


def _requests(cfg, budgets, n_prefixed):
    """Full-prompt requests, then `n_prefixed` prefix-cached ones over two
    shared images (their suffix passes run between decode chunks)."""
    proc = VisionTextProcessor(make_tiny_tokenizer(cfg), cfg, seq_bucket=32, patch_bucket=PATCHES)
    proc.prepare(cfg.text.vocab_size)
    img = lambda s: ProcessedImage(None, GRID, np.random.RandomState(s).randint(0, 256, (GRID[1] * GRID[2], 588)).astype(np.uint8))
    n_full = len(budgets) - n_prefixed
    reqs = []
    for i in range(n_full):
        b = proc.build_batch([PROMPTS[i % len(PROMPTS)]], [img(i)], prompt_bucket=128, patch_bucket=PATCHES)
        reqs.append(Request(batch=b.data, rope_delta=int(b.rope_deltas[0]), max_new_tokens=budgets[i], uid=i))
    pbs = [proc.build_prefix_batch(img(50 + j), prefix_bucket=96, patch_bucket=PATCHES) for j in range(2)]
    pre = [SharedPrefix(key=j, batch=pb.data, rope_delta=int(pb.rope_deltas[0])) for j, pb in enumerate(pbs)]
    for i in range(n_full, len(budgets)):
        sfx = np.asarray(proc.build_suffix_ids(PROMPTS[i % len(PROMPTS)]), np.int32)
        reqs.append(Request(prefix=pre[i % 2], suffix_ids=sfx, max_new_tokens=budgets[i], uid=i))
    return reqs


def _tallies():
    return [dict(t) for t in launch_tallies()]


def _launched(before):
    """Launches since `before` by (tally, key), as the kernel wrappers count them."""
    return {(i, k): n - b.get(k, 0) for i, (t, b) in enumerate(zip(launch_tallies(), before)) for k, n in t.items()
            if n != b.get(k, 0)}


def _kernel(launched, name):
    return sum(n for (_, k), n in launched.items() if k == name)


def _hand_written(fn):
    """The port's own kernels (namespace `padt`) by name as a `torch.profiler`
    trace of `fn()` names them on the device (the benchmark's busy time and
    rooflines read such names)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return Counter(e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and "padt::" in e.name)


def _run(eng, reqs):
    """One run: completions by uid, stats, launches, and (steps asked, steps
    run) of every decode chunk."""
    log, chunk = [], eng._chunk

    def logged(n, rec):
        s0 = eng.state.steps
        chunk(n, rec)
        log.append((n, eng.state.steps - s0))

    eng._chunk = logged
    before = _tallies()
    res, st = eng.run(reqs)
    torch.cuda.synchronize()
    eng._chunk = chunk
    return {c.uid: c for c in res}, st, _launched(before), log


def _same(res, ref):
    assert set(res) == set(ref)
    for uid, c in res.items():
        assert c.n_gen == ref[uid].n_gen, uid
        np.testing.assert_array_equal(c.tokens, ref[uid].tokens, err_msg=f"req {uid}")
        a, b = c.hidden[: c.n_gen].float(), ref[uid].hidden[: c.n_gen].float()
        assert (a - b).abs().max().item() <= HID_TOL * (1.0 + b.abs().max().item()), uid


@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_graph_replay_equals_eager_serving(dev, weights):
    """Ten requests (two of them prefix-cached) through a 4-slot pool:
    several chunks with admissions between them and the pool draining
    mid-chunk. The engine that replays its graph serves the eager engine's
    tokens and hidden states and launches the same kernels, as the tallies
    count them; it captures once, on its first run, and replays every step
    after the first; a second run replays every step and serves the same.
    A profiler trace of one replay names each hand-written kernel of one
    eager step as many times: the launches a replay adds to the tallies are
    measured once here."""
    cfg, params = _model(dev, weights)
    budgets = [5, 12, 3, 9, 7, 4, 11, 2, 6, 8]
    reqs = _requests(cfg, budgets, n_prefixed=2)
    kw = dict(n_slots=4, max_new_tokens=12, prompt_len=128, prefill_bucket=2, prefill_bucket_small=1, chunk_steps=4,
              patch_bucket=PATCHES, collect_hidden=True)
    eager = ServeEngine(params, cfg, **kw)
    eager._decode_graphs.limit = 0  # every step eager, the engine otherwise the same
    ref, st_e, n_e, log_e = _run(eager, reqs)
    graphed = ServeEngine(params, cfg, **kw)
    res, st, n_g, log_g = _run(graphed, reqs)

    _same(res, ref)
    assert len({c.n_gen for c in ref.values()}) > 2 and any(len(set(c.tokens.tolist())) > 2 for c in ref.values())
    assert log_g == log_e and any(done < asked for asked, done in log_g)  # the pool drained mid-chunk
    assert (st.decode_steps, st.generated_tokens, st.suffix_passes) == (st_e.decode_steps, st_e.generated_tokens, st_e.suffix_passes)
    assert st.suffix_passes > 0 and len(log_g) > 2
    assert (st_e.graph_captures, st_e.graph_steps) == (0, 0)
    assert (st.graph_captures, st.graph_steps) == (1, st.decode_steps - 1)
    assert n_g == n_e
    assert _kernel(n_g, "int8_decode_attn") == cfg.text.num_hidden_layers * st.decode_steps
    assert (_kernel(n_g, "int8_matmul") > 0) == (weights == "int8")

    again, st2, n_2, _ = _run(graphed, reqs)  # the prefixes now hit the engine's prefix cache
    _same(again, ref)
    assert (st2.graph_captures, st2.graph_steps) == (0, st2.decode_steps)
    assert _kernel(n_2, "int8_decode_attn") == cfg.text.num_hidden_layers * st2.decode_steps

    replayed = _hand_written(lambda: graphed._decode_graphs.replay("step"))
    step = lambda: S._plain_step(graphed.params, cfg, graphed.state, graphed.sampling, rec=Recorder())  # its packed weights
    eager_step = _hand_written(step)
    assert replayed == eager_step, (replayed, eager_step)
    named = lambda kernel: sum(n for k, n in replayed.items() if kernel in k)
    assert (named("padt::decode_kernel"), named("store_rows_flat_kernel")) == (cfg.text.num_hidden_layers, 1)  # H4, H6
    assert (named("gemm_kernel<true") > 0) == (weights == "int8")  # H7


def test_graph_under_sampling(dev):
    """do_sample=True: the capture registers the engine's generator with
    the graph, so the steps after the first replay it and sample the eager
    engine's tokens from the same seed, leaving the generator at the eager
    engine's offset. Each replay draws anew: the offset moves on by a
    step's draws at every replay."""
    cfg, params = _model(dev, "bf16")
    reqs = _requests(cfg, [6, 9, 4, 7, 5, 12], n_prefixed=0)
    kw = dict(n_slots=4, max_new_tokens=12, prompt_len=128, prefill_bucket=2, chunk_steps=4, patch_bucket=PATCHES,
              do_sample=True, temperature=0.8, top_k=20, seed=123)
    eager = ServeEngine(params, cfg, **kw)
    eager._decode_graphs.limit = 0
    ref, st_e, _, log_e = _run(eager, reqs)
    graphed = ServeEngine(params, cfg, **kw)
    res, st, _, log_g = _run(graphed, reqs)
    assert log_g == log_e
    for uid, c in res.items():
        np.testing.assert_array_equal(c.tokens, ref[uid].tokens, err_msg=f"req {uid}")
    assert graphed.state.generator.get_offset() == eager.state.generator.get_offset() > 0
    assert (st.graph_captures, st.graph_steps) == (1, st.decode_steps - 1)
    gen, offsets = graphed.state.generator, []
    for _ in range(3):
        offsets.append(gen.get_offset())
        graphed._decode_graphs.replay("step")
    offsets.append(gen.get_offset())
    assert len({b - a for a, b in zip(offsets, offsets[1:])}) == 1 and offsets[1] > offsets[0]
