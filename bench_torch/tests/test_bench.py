"""CPU rehearsal of the benchmark at the program's tiny shapes, with the
kernels' plain twins (the program's CPU path).

    python -m pytest bench_torch/tests -q

Holds: the result line's keys; the end-to-end arithmetic over all of the
window's work; that nothing the benchmark runs imports JAX, the JAX package
or the old bench scripts; that a token altered where the program produces
it, or a fault in the program's preprocessing, makes `correct` false; that
the benchmark builds the same inputs as the program; and that the control
(the reference computed in fp8) reads above the program on the same served
tokens and fails the cell's check.
"""

import ast
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bench_torch.lib import harness
from bench_torch.lib.record import Record, Served
from bench_torch.tests.tiny import LIMITS, tiny_model, tiny_traffic

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
SEED = 2**33 + 17  # beyond 32 bits, as the driver's seeds are

CELLS = {"padt3b.refcoco_stream": False, "padt7b_int8.refcoco_stream": True}  # int8 text weights


def _bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def _run(workload, seconds=1.0, dtype=torch.float32):
    return harness.run_cell(_bench(), workload, tiny_model(int8=CELLS[workload]), tiny_traffic(), LIMITS, SEED,
                            seconds, False, "cpu", time.time(), dtype=dtype, log=lambda *a: None)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_result_line(workload):
    out = _run(workload)
    assert list(out)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    names = {n for n, _, _ in harness.cell_metrics(_bench(), workload, trace=False)}
    assert set(out["metrics"]) == names and "setup_s" in names
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["device"]["platform"] == "cpu"  # a CPU run never reads as a device
    assert out["check"]["max_logit_gap"]["value"] <= LIMITS["max_logit_gap"]["limit"]
    assert out["check"]["inputs_differ"]["value"] == 0
    json.dumps(out)


def _alter_tokens(monkeypatch):
    """Alter tokens where the program produces them: every third token
    choice of the run, in every row, moves to the next id."""
    from padt_tpu_torch.models import padt as P

    orig, calls = P.sample_token, [0]

    def sample_token(logits, *a, **k):
        tok = orig(logits, *a, **k)
        calls[0] += 1
        return (tok + 1) % 900 if calls[0] % 3 == 0 else tok

    monkeypatch.setattr(P, "sample_token", sample_token)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_altered_token_is_not_correct(workload, monkeypatch):
    """The fault a served cell can have: a token altered where it is
    produced. The rest of the run is the harness's own, past its look for
    a chip."""
    _alter_tokens(monkeypatch)
    out = _run(workload)
    assert out["correct"] is False
    assert out["check"]["max_logit_gap"]["value"] > LIMITS["max_logit_gap"]["limit"]


def test_rates_are_over_the_whole_window():
    """queries_per_s is every served query over the whole window (chunks
    of unequal length weigh by their queries, not as a median of chunks),
    and the host-clock readers sum over every chunk that ran without the
    profiler."""
    rec = Record(model=tiny_model(), traffic=tiny_traffic(), window_s=10.0)
    rec.served = [Served(index=i, grid=(1, 8, 8), prompt_tokens=50, tokens=np.arange(4)) for i in range(20)]
    load = lambda kind, name: harness._reader(kind, name)
    assert load("end_to_end", "queries_per_s")(rec) == pytest.approx(2.0)
    # three chunks: the second ran under the profiler and is left out of the host-clock readings
    rec.chunk_stats = [{"decode_steps": 10, "engine_decode_s": 0.3, "generated_tokens": 40}] * 2
    rec.chunk_stats.insert(1, {"decode_steps": 10, "engine_decode_s": 0.9, "generated_tokens": 0})
    rec.chunk_wall_s, rec.chunk_wait_s, rec.chunk_traced = [4.0, 9.0, 6.0], [1.0, 0.0, 1.5], [False, True, False]
    assert load("metrics", "prefetch_wait_share.stream")(rec) == pytest.approx(25.0)
    assert load("metrics", "decode_ms_per_step.stream")(rec) == pytest.approx(30.0)
    assert load("metrics", "slot_utilization.stream")(rec) == pytest.approx(100.0 * 80 / (20 * 4))


def test_inputs_equal_the_programs():
    """The benchmark's own input of every query of two blocks (the client
    resize, smart_resize, the patch rows, the template and its image pads)
    is the program's, byte for byte."""
    from bench_torch.lib import inputs, traffic as traffic_gen
    from bench_torch.loops import stream

    model, traffic = tiny_model(), tiny_traffic()
    program = stream.program_input(model, traffic)
    qs = traffic_gen.queries(traffic, SEED)
    for _ in range(2 * traffic["block"]):
        q = next(qs)
        rows, grid = inputs.patch_rows(inputs.client_image(q.pixels(), traffic["max_side"]), model)
        ids, p_rows, p_grid = program(q)
        assert grid == p_grid and np.array_equal(rows, p_rows)
        assert np.array_equal(inputs.prompt_ids(q.prompt, grid, model), ids)


def test_preprocessing_fault_is_not_correct(monkeypatch):
    """A fault in the program's preprocessing (patch rows out of order)
    reaches the program's input and not the reference's: `correct` false."""
    from padt_tpu_torch.preprocess import vision_process as V

    orig = V.process_image

    def flipped(*a, **k):
        p = orig(*a, **k)
        p.pixel_patches_u8 = p.pixel_patches_u8[::-1].copy()
        return p

    monkeypatch.setattr(V, "process_image", flipped)
    out = _run("padt3b.refcoco_stream")
    assert out["correct"] is False and out["check"]["inputs_differ"]["value"] > 0


def test_traced_chunk_runs_after_the_window(monkeypatch):
    """With the trace on, the window is an untraced run's and one chunk
    more runs under the profiler after it (here a stand-in that reads one
    millisecond of device work): the traced line carries the per-layer
    metrics, the busy and window seconds and the breakdown."""
    from bench_torch.lib.trace import DeviceTrace
    from bench_torch.loops import stream

    class Stand(DeviceTrace):
        def start(self):
            self.t0 = time.time_ns()

        def stop(self):
            self.t1 = time.time_ns()
            self.ops = [("kernel", self.t0, self.t0 + 10**6)]

    monkeypatch.setattr(stream, "DeviceTrace", Stand)
    keep = {}
    out = harness.run_cell(_bench(), "padt3b.refcoco_stream", tiny_model(), tiny_traffic(), LIMITS, SEED, 1.0, True,
                           "cpu", time.time(), dtype=torch.float32, log=lambda *a: None, keep=keep)
    rec = keep["rec"]
    assert rec.chunk_traced[-1] and not any(rec.chunk_traced[:-1])
    assert out["correct"] is True and out["device"]["busy_s"] == pytest.approx(1e-3)
    assert out["breakdown"]["device_ops"][0][0] == "kernel"
    want = {n for n, _, _ in harness.cell_metrics(_bench(), "padt3b.refcoco_stream", trace=True)}
    assert set(out["metrics"]) == want
    walls = [w for w, tr in zip(rec.chunk_wall_s, rec.chunk_traced) if not tr]
    assert out["metrics"]["idle_share.stream"]["value"] == pytest.approx(100 * (1 - 1e-3 / (sum(walls) / len(walls))))
    served = [s for s in rec.served if not s.traced]
    assert harness._reader("end_to_end", "queries_per_s")(rec) == pytest.approx(len(served) / rec.window_s)


def test_device_metrics_have_no_cpu_reading():
    rec = Record(model=tiny_model(), traffic=tiny_traffic(), window_s=1.0)
    for name in ("idle_share.stream", "int8_matmul_roofline"):
        assert harness._reader("metrics", name)(rec) is None


@pytest.mark.parametrize("workload", ["padt3b.refcoco_stream", "padt7b_int8.refcoco_stream"])
def test_control_reads_above_the_program(workload):
    """The control, the reference computed a step below the stated
    precision (fp8 products; int4 text weights where the configuration
    states int8), on the program's own served tokens, reads a wider gap
    than the program on every seed tried. (On the card, at the cells' own
    sizes, `bench_torch/control.py` reads both over a dozen seeds.)"""
    from bench_torch.lib import check as chk

    from bench_torch.loops import stream

    int8 = CELLS[workload]
    model, traffic = tiny_model(int8=int8, vocab_size=16384), tiny_traffic()
    traffic.update(output_lengths=[[12, 4], [16, 4]], check_requests=8)
    # the tiny cells' limit, set as the cells' are: bf16 runs read 0-0.085 over six seeds, the
    # controls 0.29-0.74 (fp8) and 0.82-1.36 (fp8 + int4 weights)
    limits = dict(LIMITS, max_logit_gap={"limit": 0.2})
    for seed in (SEED, SEED + 1, SEED + 2):
        keep = {}
        out = harness.run_cell(_bench(), workload, model, traffic, limits, seed, 0.5, False, "cpu", time.time(),
                               dtype=torch.bfloat16, log=lambda *a: None, keep=keep)
        control = "fp8_int4" if int8 else "fp8"
        prog, ctrl, _, _ = chk.readings(keep["rec"], keep["weights"], model, traffic, seed, "cpu", control=control)
        assert ctrl > 3 * prog and ctrl > 0, (seed, prog, ctrl)
        # the program passes the check at the limit; the control, in its place, fails it
        assert out["correct"] is True
        correct, numbers = stream.check(keep["rec"], keep["weights"], model, traffic, seed, "cpu", limits,
                                        control=control)
        assert correct is False and numbers["max_logit_gap"]["value"] == pytest.approx(ctrl), (seed, numbers)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_imports_neither_jax_nor_the_jax_package():
    banned = ("jax", "padt_tpu", "bench", "bench_train", "chip_smoke")
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                for mod in _imports(os.path.join(dirpath, f)):
                    top = mod.split(".")[0]
                    assert top not in banned, f"{f} imports {mod}"
    code = (
        "import sys; sys.path.insert(0, %r); import bench_torch.lib.harness, bench_torch.lib.check, "
        "bench_torch.loops.stream, bench_torch.lib.inputs, bench_torch.references.padt_qwen25vl, "
        "bench_torch.lib.model as m; import padt_tpu_torch.eval.harness; "
        "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'padt_tpu', 'bench', 'bench_train')))"
    ) % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"


def test_trace_arithmetic():
    """Busy time is the union of the device ops clipped to the window,
    each idle gap goes to the innermost host span open at its middle, and
    the idle share sets the busy time of a chunk against an untraced
    chunk's wall."""
    from bench_torch.lib.trace import DeviceTrace, Spans

    t = DeviceTrace()
    t.t0, t.t1 = 0, 100
    t.ops = [("a", -5, 10), ("b", 5, 20), ("a", 50, 60), ("c", 95, 130)]
    assert t.busy_intervals() == [(0, 20), (50, 60), (95, 100)]
    assert t.busy_s() == pytest.approx(35e-9)
    assert t.op_seconds(["a"]) == pytest.approx(25e-9)
    assert t.top_ops()[0][0] == "c"
    spans = Spans()
    spans.items = [("outer", 0, 100), ("inner", 25, 45)]
    assert dict(t.idle_gaps(spans)) == pytest.approx({"inner": 30e-9, "outer": 35e-9})
    # the idle share: busy per traced chunk against the untraced chunks' mean wall, not the traced
    # chunk's own wall, which the profiler's host overhead lengthens
    rec = Record(model=tiny_model(), traffic=tiny_traffic())
    rec.trace, rec.chunk_traced, rec.chunk_wall_s = t, [False, True, False], [60e-9, 300e-9, 80e-9]
    assert harness._reader("metrics", "idle_share.stream")(rec) == pytest.approx(50.0)


def test_counts():
    """The tower's windows tile the image, and a query's operations grow by
    one decode forward per served token."""
    from bench_torch.lib import counts

    model = harness.load_json(os.path.join(HERE, "configs", "padt3b.json"))
    for grid in ((1, 46, 46), (1, 34, 46), (1, 30, 46)):
        assert sum(counts.window_sizes(grid, model)) == grid[1] * grid[2]
    one, two = (counts.query_flops(model, (1, 34, 46), 440, n) for n in (20, 21))
    nl, d, qd = model["num_hidden_layers"], model["hidden_size"], model["num_attention_heads"] * model["head_dim"]
    # the 21st token: its decode forward over the prompt and 20 tokens, and its logits
    step = 2 * counts.text_layer_params(model) * nl + 4 * qd * nl * (440 + 20) + 2 * d * (model["vocab_size"] + 17 * 23)
    assert two - one == pytest.approx(step)
    ops, nbytes = counts.int8_product_work(model, rows=0, forwards=1)
    assert ops == 0 and nbytes == model["num_hidden_layers"] * sum(
        k * n + 4 * n for k, n in counts.text_layer_weights(model).values())
