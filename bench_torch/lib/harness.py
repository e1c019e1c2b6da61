"""One run of one cell: the seeded weights and engine, the warm-up, the
window, the metrics, the device reading, then the check against the plain
reference. Everything a cell needs is found by name: its configuration
file, its traffic file (whose `loop` names a module of `loops/`, which
builds, drives and checks the program), its limits file, and one file per
metric under `end_to_end/` and `metrics/`.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import time
from typing import Dict, Optional


from . import layout
from .record import Record

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # bench_torch/
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: Dict, workload: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    model = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "limits", workload + ".json"))
    return cell, model, traffic, limits


def _reader(kind: str, name: str):
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_torch.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: Dict, workload: str, trace: bool):
    """(name, unit, reader kind) of the metrics this cell reports in a run
    with or without the trace."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return [(m["name"], m["unit"], "end_to_end") for m in e2e]
    moved = {m["name"] for m in e2e}
    return [
        (m["name"], m["unit"], "metrics") for m in bench["per_layer"]
        if workload in m.get("workloads", [workload] if m["moves"] in moved else [])
    ]


def free_device() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_cell(
    bench: Dict, workload: str, model: Dict, traffic: Dict, limits: Dict, seed: int, seconds: float,
    trace: bool, device, t_process: float, dtype=None, log=print, keep: Optional[Dict] = None, warm: bool = True,
) -> Dict:
    """The result line of one run, as a dict. The traffic's `loop` names
    the module of `loops/` that builds the program's system, runs the
    warm-up and the window, and decides `correct`. `keep`, where given, is
    filled with the run's record and weights. warm=False skips the warm-up
    (for readings that time nothing)."""
    import torch

    dtype = dtype or torch.bfloat16
    loop = importlib.import_module(f"bench_torch.loops.{traffic['loop']}")
    weights = layout.make_weights(model, seed, device, dtype)
    system = loop.build(weights, model, traffic, device)
    rec = Record(model=model, traffic=traffic)
    loop.run(system, rec, seed, seconds, trace, warm=warm, log=log)
    rec.setup_s = rec.window_start - t_process
    on_gpu = torch.device(device).type == "cuda"
    dev_info = {
        "platform": "gpu" if on_gpu else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
        "count": 1,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if on_gpu else 0,
    }
    metrics = {}
    for name, unit, kind in cell_metrics(bench, workload, trace):
        v = _reader(kind, name)(rec)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": unit}
    out = {"correct": False, "attempted": rec.attempted, "failed": rec.failed, "metrics": metrics, "device": dev_info}
    if trace and rec.trace is not None:
        dev_info["busy_s"] = rec.trace.busy_s()
        dev_info["window_s"] = rec.trace.window_s
        out["breakdown"] = {"device_ops": rec.trace.top_ops(), "idle_gaps": rec.trace.idle_gaps(rec.spans)}
        rec.trace.ops = []
    log(f"[window] {workload} seed {seed}: {rec.attempted} attempted in {rec.window_s:.3f} s, "
        f"set-up {rec.setup_s:.3f} s, metrics {json.dumps(metrics)}")

    # the check runs once the program's state is freed
    del system
    free_device()
    t0 = time.perf_counter()
    correct, numbers = loop.check(rec, weights, model, traffic, seed, device, limits)
    log(f"[check] {time.perf_counter() - t0:.3f} s")
    out["correct"] = bool(correct and rec.failed == 0 and rec.attempted > 0)
    out["check"] = numbers
    if keep is not None:
        keep.update(rec=rec, weights=weights)
    return out
