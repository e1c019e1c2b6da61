"""CPU rehearsal of the sparse-expert cell (`keye30b_a3b.refcoco_stream`)
at a tiny Keye configuration (the program's tiny widths, 16 experts of
width 32, 8 a token), with the kernels' plain twins: the result line, an
altered served token, faults planted in the program's expert path, the
control against the program, the layout's leaves and counts at the
published sizes, and the cell's readers on a stand-in record.

    python -m pytest bench_torch/tests/test_keye_moe.py -q
"""

import json
import math
import os
import time

import numpy as np
import pytest
import torch

from bench_torch.layouts import keye_moe
from bench_torch.lib import counts, harness, layout
from bench_torch.lib.record import Record, Served
from bench_torch.lib.trace import DeviceTrace
from bench_torch.tests.test_bench import _alter_tokens
from bench_torch.tests.tiny import LIMITS, tiny_model, tiny_traffic

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
SEED = 2**33 + 29  # beyond 32 bits, as a benchmark run's seeds may be
CELL = "keye30b_a3b.refcoco_stream"
# the serve engine's, device's, harness's and model step's metrics of the dense cells, and H11's roofline
TRACED = ("prefetch_wait_share.stream", "decode_ms_per_step.stream", "slot_utilization.stream", "mfu.stream",
          "idle_share.stream", "decode_host_ms_per_step.stream", "decode_readback_ms_per_step.stream",
          "admission_host_ms.stream", "tower_pad_share.stream", "prefill_pad_share.stream",
          "idle_in_launch_share.stream", "decode_graph_share.stream", "expert_gemm_roofline")


def tiny_keye(vocab_size: int = 1024):
    m = tiny_model("keye30b_a3b", vocab_size=vocab_size)
    m.update(num_experts=16, num_experts_per_tok=8, moe_intermediate_size=32)
    return m


def _bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def _run(model=None, traffic=None, limits=LIMITS, seed=SEED, dtype=torch.float32, keep=None, trace=False):
    return harness.run_cell(_bench(), CELL, model or tiny_keye(), traffic or tiny_traffic(), limits, seed, 1.0, trace,
                            "cpu", time.time(), dtype=dtype, log=lambda *a: None, keep=keep)


def _published():
    return harness.load_json(os.path.join(HERE, "configs", "keye30b_a3b.json"))


def test_result_line():
    keep = {}
    out = _run(keep=keep)
    assert list(out)[-1] == "check"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    names = {n for n, _, _ in harness.cell_metrics(_bench(), CELL, trace=False)}
    assert names == {"queries_per_s", "setup_s"} == set(out["metrics"])
    assert {n for n, _, _ in harness.cell_metrics(_bench(), CELL, trace=True)} == set(TRACED)
    assert out["device"]["platform"] == "cpu"
    assert out["check"]["inputs_differ"]["value"] == 0
    # the program's counters reach the record: every chunk routed its real tokens through the experts
    stats = keep["rec"].chunk_stats
    assert all(s["decode_expert_rows"] > 0 and s["prefill_expert_rows"] > 0 for s in stats)
    assert all(s["moe_forwards"] == s["decode_steps"] + s["admissions"] for s in stats)
    json.dumps(out)


def test_altered_token_is_not_correct(monkeypatch):
    _alter_tokens(monkeypatch)
    out = _run()
    assert out["correct"] is False
    assert out["check"]["max_logit_gap"]["value"] > LIMITS["max_logit_gap"]["limit"]


def _plant(monkeypatch, fault):
    """A fault in the program's expert path: the experts' output dropped,
    the top-k weights left as the full softmax's (not renormalised), or
    every choice sent to the next expert."""
    from padt_tpu_torch.models import language
    from padt_tpu_torch.ops import moe

    mlp, route = language.moe_mlp, moe.route
    if fault == "experts_dropped":
        monkeypatch.setattr(language, "moe_mlp", lambda *a, **k: mlp(*a, **k) * 0)
    elif fault == "unnormalised":
        monkeypatch.setattr(moe, "route", lambda xn, rw, k, norm: route(xn, rw, k, False))
    else:
        def shifted(xn, rw, k, norm):
            w, ids = route(xn, rw, k, norm)
            return w, (ids + 1) % rw.shape[1]

        monkeypatch.setattr(moe, "route", shifted)


@pytest.mark.parametrize("fault", ["experts_dropped", "unnormalised", "next_expert"])
def test_planted_expert_fault_is_not_correct(monkeypatch, fault):
    """Each fault serves other tokens than the reference's best by more
    than the limit. 64 experts, so that the 8 chosen hold a small share of
    the router's mass and skipping the renormalisation shrinks the MoE's
    output as it does at 128."""
    model = tiny_keye()
    model.update(num_experts=64)
    assert _run(model)["correct"] is True
    _plant(monkeypatch, fault)
    out = _run(model)
    assert out["correct"] is False
    assert out["check"]["max_logit_gap"]["value"] > LIMITS["max_logit_gap"]["limit"]


def test_control_reads_above_the_program():
    """The control (the reference with fp8 products, the router's and the
    experts' included) on the program's own bf16 served tokens reads a
    wider gap than the program and fails the check the program passes."""
    from bench_torch.lib import check as chk
    from bench_torch.loops import stream

    model, traffic = tiny_keye(vocab_size=16384), tiny_traffic()
    traffic.update(output_lengths=[[12, 4], [16, 4]], check_requests=8)
    # set as the dense cells' tiny limit (bench_torch/tests/test_bench.py), between the readings: bf16 runs
    # read 0.002-0.040 over six seeds from SEED, the fp8 control 0.149-0.461 (the window's length moves
    # the sample from run to run)
    limits = dict(LIMITS, max_logit_gap={"limit": 0.1})
    for seed in (SEED, SEED + 1, SEED + 2):
        keep = {}
        out = _run(model, traffic, limits, seed, torch.bfloat16, keep)
        prog, ctrl, _, _ = chk.readings(keep["rec"], keep["weights"], model, traffic, seed, "cpu", control="fp8")
        assert ctrl > 3 * prog and ctrl > 0, (seed, prog, ctrl)
        assert out["correct"] is True
        correct, numbers = stream.check(keep["rec"], keep["weights"], model, traffic, seed, "cpu", limits,
                                        control="fp8")
        assert correct is False and numbers["max_logit_gap"]["value"] == pytest.approx(ctrl), (seed, numbers)


def test_text_spec_and_flops_at_the_published_sizes():
    m = _published()
    assert m["layout"] == "keye_moe" and m["reference"] == "padt_keye_moe" and m["reduced"] == []
    leaves = {"/".join(p): (s, k) for p, s, k in layout._leaves(layout.spec(m)["text"])}
    nl, d, e, fe = 48, 2048, 128, 768
    assert leaves == {
        "embed": ((151936, d), "w"), "lm_head": ((151936, d), "w"), "final_ln_w": ((d,), "one"),
        "layers/input_ln_w": ((nl, d), "one"), "layers/post_ln_w": ((nl, d), "one"),
        "layers/qkv_w": ((nl, d, 4096 + 2 * 512), "w"), "layers/o_w": ((nl, 4096, d), "w"),
        "layers/q_norm_w": ((nl, 128), "one"), "layers/k_norm_w": ((nl, 128), "one"),
        "layers/router_w": ((nl, d, e), "w"), "layers/experts_gateup_w": ((nl, e, d, 2 * fe), "w"),
        "layers/experts_down_w": ((nl, e, fe, d), "w"),
    }
    total = sum(math.prod(s) for s, _ in leaves.values())
    assert total == 30_532_122_624  # 61.1 GB in bf16
    # active parameters a token: 2.73 B in the text layers, 3.04 B with the head
    assert keye_moe.active_layer_params(m) * nl == 2_730_491_904
    assert keye_moe.active_layer_params(m) * nl + 151936 * d == 3_041_656_832
    one, two = (keye_moe.text_flops(m, 600, n) for n in (20, 21))
    # the 21st token: its decode forward through the active weights, attending over the prompt and 20 tokens
    assert two - one == pytest.approx(2 * 2_730_491_904 + 4 * 4096 * nl * (600 + 20))
    q1, q2 = (counts.query_flops(m, (1, 34, 46), 600, n) for n in (20, 21))
    assert q2 - q1 == pytest.approx(two - one + 2 * d * (151936 + 17 * 23))
    ops, nbytes = keye_moe.expert_work(m, rows=10, experts_hit=3)
    assert ops == 2 * 10 * 3 * d * fe and nbytes == 2 * 3 * 3 * d * fe + 2 * 10 * 2 * (d + fe)
    assert 2 * 3 * d * fe == 9_437_184  # one expert's bytes in bf16: 9.44 MB


class _Trace(DeviceTrace):
    def __init__(self, ops):
        super().__init__()
        self.t0, self.t1, self.ops = 0, 10**9, ops


def _stand_in(model):
    rec = Record(model=model, traffic=tiny_traffic(), window_s=2.0)
    stats = {"decode_steps": 40, "graph_steps": 40, "admissions": 4, "decode_expert_rows": 40 * 20 * 8 * 48,
             "decode_experts_hit": 40 * 48 * 100, "prefill_expert_rows": 4 * 2400 * 8 * 48,
             "prefill_experts_hit": 4 * 48 * 128, "moe_forwards": 44}
    rec.chunk_stats = [dict(stats), dict(stats, decode_experts_hit=40 * 48 * 90), dict(stats)]
    rec.chunk_wall_s, rec.chunk_traced = [1.0, 1.0, 1.5], [False, False, True]
    rec.served = [Served(index=i, grid=(1, 34, 46), prompt_tokens=600, tokens=np.arange(20), traced=i >= 8)
                  for i in range(12)]
    return rec


def test_readers_on_a_stand_in_record():
    """`mfu.stream` counts the Keye queries through the layout's active
    weights; `expert_gemm_roofline` sets the traced chunks' expert work
    against H11's device time."""
    m = _published()
    rec = _stand_in(m)
    read = lambda name: harness._reader("metrics", name)(rec)
    ops = sum(counts.query_flops(m, (1, 34, 46), 600, 20) for _ in range(8))
    assert read("mfu.stream") == pytest.approx(100 * ops / (2.0 * counts.BF16_FLOPS))
    assert read("expert_gemm_roofline") is None  # no trace
    kernel_s = 1.0
    rec.trace = _Trace([("void expert_gemm_kernel<true, 64, true>(Params)", 0, int(kernel_s * 1e9)),
                        ("other", 0, 10**9)])
    least = 0.0
    for rows, hit in ((40 * 20 * 8 * 48, 40 * 48 * 100), (4 * 2400 * 8 * 48, 4 * 48 * 128)):
        least += counts.least_seconds(*keye_moe.expert_work(m, rows, hit))
    assert read("expert_gemm_roofline") == pytest.approx(100 * least / kernel_s)
    assert 0 < read("expert_gemm_roofline") <= 100


def test_roofline_reads_nothing_from_a_program_without_the_counters():
    """The parent program has no expert counters and no H11: nothing, and
    no error; nor from a dense configuration."""
    m = _published()
    rec = _stand_in(m)
    for st in rec.chunk_stats:
        for k in ("decode_expert_rows", "decode_experts_hit", "prefill_expert_rows", "prefill_experts_hit"):
            st.pop(k)
    rec.trace = _Trace([("expert_gemm_kernel", 0, 10**8)])
    assert harness._reader("metrics", "expert_gemm_roofline")(rec) is None
    dense = _stand_in(tiny_model())
    dense.trace = _Trace([("expert_gemm_kernel", 0, 10**8)])
    assert harness._reader("metrics", "expert_gemm_roofline")(dense) is None
