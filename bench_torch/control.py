"""The readings a cell's correctness limit is set from, on the card, at
the cell's own sizes, and the control's verdict under the committed
limits. For each seed: one short window of the program (no warm-up:
nothing is timed), judged by the cell's own check (`correct`; the widest
logit gap of its served tokens against the float32 reference, whose
largest over the seeds is the lower reading); then the same check with
the control in the program's place: the reference computed a step below
the configuration's precision (fp8 products; int4 text weights where the
configuration states int8), on the same prompts and served tokens, judged
by the gap of the token it puts first (the smallest over the seeds is the
upper reading). The control has to come out not correct on every seed.
All seeds run in one process.

    python3 bench_torch/control.py --workload padt3b.refcoco_stream --seeds 12 --first 4100000001

Prints one JSON line per seed and a summary line. Needs CUDA.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, required=True, help="the first seed; the others follow it")
    ap.add_argument("--seconds", type=float, default=1.0, help="window per seed: one chunk or a few queries")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import importlib

    from bench_torch.lib.harness import find_cell, free_device, load_json, run_cell

    if not torch.cuda.is_available():
        raise SystemExit("control.py needs a CUDA device")
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    _, model, traffic, limits = find_cell(bench, args.workload)
    loop = importlib.import_module(f"bench_torch.loops.{traffic['loop']}")
    control = "fp8_int4" if model["text_layer_weights"] == "int8" else "fp8"
    dev = torch.device("cuda", 0)
    rows = []
    for seed in range(args.first, args.first + args.seeds):
        keep = {}
        t0 = time.time()
        out = run_cell(bench, args.workload, model, traffic, limits, seed, args.seconds, False, dev, t0,
                       log=lambda *a: None, keep=keep, warm=False)
        ctrl_correct, ctrl_numbers = loop.check(keep["rec"], keep["weights"], model, traffic, seed, dev, limits,
                                                control=control)
        rows.append({"seed": seed, "correct": out["correct"], "program": out["check"]["max_logit_gap"]["value"],
                     "control_correct": ctrl_correct, "control": ctrl_numbers["max_logit_gap"]["value"],
                     "tokens": out["check"]["tokens_checked"]["value"], "s": time.time() - t0})
        print(json.dumps(rows[-1]), flush=True)
        keep.clear()
        free_device()
    print(json.dumps({"workload": args.workload, "control": control, "lower": max(r["program"] for r in rows),
                      "upper": min(r["control"] for r in rows), "limit": limits["max_logit_gap"]["limit"],
                      "program_correct": sum(r["correct"] for r in rows),
                      "control_correct": sum(r["control_correct"] for r in rows), "seeds": len(rows),
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if all(r["correct"] and not r["control_correct"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
