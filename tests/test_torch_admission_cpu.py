"""The serve engine's admissions on the CPU, where every one runs eagerly:
no admission graph is captured or replayed (`serve.engine.Graphs` captures
on the card only; `tests/test_torch_admission_graph.py` holds the graphs
against eager admissions there), the device row mask that marks a
bucket's real rows for the expert tally, and `Graphs`' rule of when to
capture, on fakes of CUDA's graph calls, for both of an engine's
instances."""

import numpy as np
import pytest
import torch

from padt_tpu_torch.models import language as L
from padt_tpu_torch.models import padt as P
from padt_tpu_torch.ops import moe as M
from padt_tpu_torch.serve import ServeEngine
from padt_tpu_torch.serve import engine as S
from padt_tpu_torch.utils import profiling
from test_torch_moe import _moe_model, _proc_requests

EAGER_SPANS = ("admit.stack", "admit.vision", "admit.prefill", "admit.insert")


def test_cpu_admits_eagerly():
    """A run on the CPU: every admission keeps its eager spans, none
    captures or replays a graph, and the engine keeps no graph. A bucket's
    rows carry the requests' rope deltas, their slots and budgets, and 0 on
    a padding row."""
    cfg, params = _moe_model()
    reqs = _proc_requests(cfg, [3, 5, 2])
    eng = ServeEngine(params, cfg, n_slots=4, max_new_tokens=8, prompt_len=128, prefill_bucket=2,
                      prefill_bucket_small=2, chunk_steps=3, patch_bucket=128, keep_artifacts=True)
    rec = profiling.Recorder()
    with profiling.recording():
        res, st = eng.run(reqs, rec=rec)
    assert len(res) == 3 and all(c.artifacts is not None for c in res)
    assert st.admissions == 2 and (st.admit_graph_replays, st.admit_graph_captures) == (0, 0)
    assert all(rec.counts[name] == st.admissions for name in EAGER_SPANS), rec.counts
    assert not {"admit.graph", "admit.capture"} & set(rec.counts)
    assert not any(eng._admit_graphs.graphs.values()) and eng._admit_graphs.pool is None
    _, rows = eng._make_bucket(reqs[2:], [3, 1])
    assert rows.tolist() == [[reqs[2].rope_delta, 0], [3, 1], [2, 0]] and rows.dtype == torch.int64


def test_row_mask_tally_equals_the_row_slice():
    """The prefill tally of a bucket with a padding row: the mask of rows
    with a budget (`budgets > 0`, on the device) counts what the first
    `n_real` rows' slice of the validity mask counted, through the engine's
    own admission."""
    cfg, params = _moe_model()
    reqs = _proc_requests(cfg, [3, 5, 2])
    eng = ServeEngine(params, cfg, n_slots=4, max_new_tokens=8, prompt_len=128, prefill_bucket=4, patch_bucket=128)
    stack, rows = eng._make_bucket(reqs, [0, 1, 2, 3])
    rec = profiling.Recorder()
    batch, rows_d = S._upload((stack, rows), eng.device)
    eng.state.moe_tally.zero_()
    eng._admission(rec, batch, rows_d)
    tc = cfg.text
    art = P.run_vision(eng.params, cfg, batch)
    embeds = P.extended_embed(eng.params, cfg, batch["input_ids"], art.proto, art.merged)
    valid = batch["attention_mask"].bool()
    real = valid.clone()
    real[len(reqs):] = False  # the slice the admission took before the mask
    old = M.Tally(torch.zeros(tc.num_hidden_layers, tc.num_experts, dtype=torch.int32), torch.zeros(2, dtype=torch.int64))
    L.prefill(eng.params["text"], tc, embeds, batch["position_ids"], valid, eng.capacity, kv_dtype="int8",
              real=real, tally=old)
    prompt = sum(int(np.asarray(q.batch["attention_mask"]).sum()) for q in reqs)
    assert eng.state.moe_tally[2:].tolist() == old.totals.tolist()
    assert old.totals[0] == prompt * tc.num_experts_per_tok * tc.num_hidden_layers
    assert eng.state.moe_tally[:2].tolist() == [0, 0]  # no decode choices


class _FakeGraph:
    """Stands in for `torch.cuda.CUDAGraph`: records replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.mark.parametrize("which", ["_decode_graphs", "_admit_graphs"])
def test_a_key_past_the_bound_runs_eagerly(monkeypatch, which):
    """`Graphs`' rule, on an engine's decode instance (one key, limit 1)
    and its admission instance (limit ADMISSION_GRAPHS), with CUDA's graph
    calls faked (the capture runs the body): on the card a key's first call
    runs eagerly, its second captures and replays, later ones replay; a key
    past the limit runs eagerly, and so does every call on the CPU or with
    `limit = 0`. A replay adds the captured body's launches to the tallies
    and takes out the capture's own; the counters count replays (the
    capturing one included) and captures until `reset`."""
    cfg, params = _moe_model()
    eng = ServeEngine(params, cfg, n_slots=4, max_new_tokens=8, prompt_len=128, prefill_bucket=2, patch_bucket=128)
    graphs = getattr(eng, which)
    limit = {"_decode_graphs": 1, "_admit_graphs": S.ADMISSION_GRAPHS}[which]
    assert graphs.limit == limit and graphs.device.type == "cpu"
    tally = {}
    monkeypatch.setattr(S, "launch_tallies", lambda: (tally,))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "graph", lambda g, pool, capture_error_mode: torch.no_grad())
    ran = []

    def body(rec, key):
        ran.append(key)
        tally["kernel"] = tally.get("kernel", 0) + 2

    call = lambda key: graphs(key, lambda r: body(r, key), rec)
    rec = profiling.Recorder()
    on_cpu = ("cpu", 0)
    call(on_cpu), call(on_cpu)
    assert ran == [on_cpu, on_cpu] and graphs.graphs == {on_cpu: None} and graphs.pool is None
    assert (graphs.captures, graphs.replays, rec.counts) == (0, 0, {})

    graphs.device = torch.device("cuda")  # the card, as far as the rule looks
    ran.clear()
    tally.clear()
    keys = [("shape", i) for i in range(limit + 2)]
    for k in keys:
        for _ in range(3):
            call(k)
    # a key within the limit: eager, then the capture (which the fake runs) and two replays; past it: eager
    assert ran == [x for k in keys[:limit] for x in (k, k)] + [x for k in keys[limit:] for x in (k, k, k)], ran
    assert [k for k, g in graphs.graphs.items() if g is not None] == keys[:limit] and graphs.pool == "pool"
    assert (graphs.captures, graphs.replays) == (limit, 2 * limit)
    assert rec.counts == {graphs.capture_span: limit, graphs.replay_span: 2 * limit}
    assert sum(g[0].replays for g in graphs.graphs.values() if g is not None) == 2 * limit
    assert tally == {"kernel": 2 * 3 * len(keys)}  # each call's 2 launches, eager or replayed; none of a capture

    graphs.reset()
    assert (graphs.captures, graphs.replays) == (0, 0)
    call(keys[0])
    assert graphs.replays == 1
    graphs.limit = 0
    fresh = ("shape", "fresh")
    call(fresh), call(fresh)
    assert ran[-2:] == [fresh, fresh] and graphs.graphs[fresh] is None and (graphs.captures, graphs.replays) == (0, 1)
