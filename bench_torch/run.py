"""The benchmark of `padt_tpu_torch` on one H100: one run of one cell.

    python3 bench_torch/run.py --workload padt3b.refcoco_stream --seed 7 --seconds 30 --trace 0

Run from the root of a checkout. Prints progress and the numbers the check
compared (last) on standard error, and as the last line of standard output
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`,
with `--trace 1` a `breakdown`, and last `check`. Exits non-zero, with no
result, where there is no CUDA device or fewer than the cell asks for.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    # every build and kernel cache of the program stays inside the checkout,
    # at fixed paths (the program's nvcc builds go to build/padt_tpu_torch/)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")

    from bench_torch.lib.harness import find_cell, load_json, run_cell

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, model, traffic, limits = find_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.cuda.set_device(0)
    out = run_cell(bench, args.workload, model, traffic, limits, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_PROCESS, log=log)
    for name, v in out["check"].items():
        log(f"check {name} {v['value']} limit {v['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
