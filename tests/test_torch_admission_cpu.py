"""The serve engine's admissions on the CPU, where every one runs eagerly:
no admission graph is captured or replayed (`serve.engine.AdmissionGraphs`
applies on the card only; `tests/test_torch_admission_graph.py` holds the
graphs against eager admissions there), the device row mask that marks a
bucket's real rows for the expert tally, and the bound on an engine's
graphs."""

import numpy as np
import torch

from padt_tpu_torch.models import language as L
from padt_tpu_torch.models import padt as P
from padt_tpu_torch.ops import moe as M
from padt_tpu_torch.serve import ServeEngine
from padt_tpu_torch.serve import engine as S
from padt_tpu_torch.utils import profiling
from test_torch_moe import _moe_model, _proc_requests

EAGER_SPANS = ("admit.stack", "admit.copy.readback", "admit.vision", "admit.prefill", "admit.insert")


def test_cpu_admits_eagerly():
    """A run on the CPU: every admission keeps its eager spans, none
    captures or replays a graph, and the engine keeps no graph and marks
    no key as admitted on the card. A bucket's rows carry the requests'
    rope deltas, their slots and budgets, and 0 on a padding row."""
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
    assert eng._admissions.graphs == {} and not eng._admissions.eager
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
    batch, rows_d = eng._upload(rec, stack, rows)
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


def test_a_key_past_the_bound_runs_eagerly():
    """A bucket shape replays a graph on the card only, once it was admitted
    eagerly there, and while the engine holds fewer than ADMISSION_GRAPHS
    graphs; a key that has one keeps it."""
    graphs = S.AdmissionGraphs()
    keys = [(4, (("input_ids", (1, 128 * (i + 1))),)) for i in range(S.ADMISSION_GRAPHS + 2)]
    assert not graphs.graphed(keys[0], on_card=True)  # first admission: eager
    graphs.eager.update(keys)
    assert not any(graphs.graphed(k, on_card=False) for k in keys)  # the CPU
    for k in keys[: S.ADMISSION_GRAPHS]:
        assert graphs.graphed(k, on_card=True)
        graphs.graphs[k] = S._AdmissionGraph({}, torch.zeros(3, 4, dtype=torch.int64))
    assert not graphs.graphed(keys[S.ADMISSION_GRAPHS], on_card=True)
    assert not graphs.graphed(keys[-1], on_card=True)
    assert all(graphs.graphed(k, on_card=True) for k in keys[: S.ADMISSION_GRAPHS])
