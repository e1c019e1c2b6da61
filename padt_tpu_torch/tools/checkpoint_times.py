"""Where the time of a checkpoint's round trip goes, by step, on PaDT-3B.

    python3 -m padt_tpu_torch.tools.checkpoint_times [--dir DIR]

Builds PaDT-3B's random bf16 weights on the card (seed 0), then times, each
step on its own: the device-to-host copy of every leaf; `export_state_dict`
(numpy transposes into HF layout); the shard writes; the reads
(`safetensors_io.load_dir`, memmap) and the conversion back
(`convert_vision` / `convert_text` / ... : numpy transposes and stacks,
touching every page); the host-to-device copy; the tokenizer attempt of
`load_model`; `torch.save` of the native file and `torch.load` of it onto
the card. Beside them, one 2048 x 11008 bf16 matrix transposed by numpy
(as the converters do) and by torch on the host. Prints one line per step
with the card's name and power limit, and removes its directory. Needs
CUDA; `--dir` is where the ~16 GB of files go (default: `tempfile`'s
directory).
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("checkpoint_times needs an NVIDIA GPU")

    from .. import padt_3b
    from ..api import _map_tree as _map, load_tokenizer, save_native
    from ..convert import hf_to_padt as H, padt_to_hf as E, safetensors_io as S
    from ..models.padt import init_padt_params

    dev, name = torch.device("cuda", 0), card()
    cfg = padt_3b()
    params = init_padt_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, torch.bfloat16)
    torch.cuda.synchronize()
    root = tempfile.mkdtemp(prefix="padt_ckpt_times_", dir=a.dir)
    times = {}

    def step(what, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[what] = time.perf_counter() - t0
        print(f"[checkpoint] {what}: {times[what]:.2f} s ({name})", flush=True)
        return out

    try:
        hf = os.path.join(root, "hf")
        os.makedirs(hf)
        host = step("device-to-host copy of every leaf", lambda: _map(S.from_torch, params))
        sd = step("export_state_dict (numpy transposes to HF layout)", lambda: E.export_state_dict(host, cfg))
        n_bytes = sum(v.nbytes for v in sd.values())
        names = sorted(sd)
        half = names[: len(names) // 2], names[len(names) // 2 :]
        step(f"write {n_bytes / 1e9:.3f} GB in 2 files",
             lambda: [S.save_file({k: sd[k] for k in part}, os.path.join(hf, f"m{i}.safetensors"))
                      for i, part in enumerate(half)])
        del host, sd
        raw = step("safetensors_io.load_dir (headers, memmap)", lambda: S.load_dir(hf))
        tree = step("convert back (numpy transposes and stacks, every page read)", lambda: {
            "vision": H.convert_vision(H.normalize_keys(raw), cfg.vision),
            "text": H.convert_text(H.normalize_keys(raw), cfg.text),
            "decoder": H.convert_decoder(H.normalize_keys(raw), cfg.decoder),
            "proto": H.convert_proto(H.normalize_keys(raw)),
        })
        dev_tree = step("to_torch onto the card (host-to-device)", lambda: _map(lambda x: S.to_torch(x, dev), tree))
        step("load_tokenizer (transformers import and a failed lookup)", lambda: load_tokenizer(hf))
        cpu_tree = _map(lambda x: S.to_torch(x, "cpu"), tree)
        del raw, tree
        step("torch.save of the native params.pt", lambda: save_native(os.path.join(root, "native"), cfg, cpu_tree))
        step("torch.load of params.pt onto the card",
             lambda: torch.load(os.path.join(root, "native", "params.pt"), map_location=dev, weights_only=True))
        same = all(torch.equal(dev_tree["text"]["layers"][k], v) for k, v in params["text"]["layers"].items())
        print(f"[checkpoint] text layers read back bit-equal: {same} ({name})", flush=True)

        m = np.random.RandomState(0).randint(0, 1 << 16, (2048, 11008)).astype(np.uint16)
        step("one 2048 x 11008 bf16 transpose, numpy", lambda: np.ascontiguousarray(m.T))
        t = torch.from_numpy(m.view(np.int16)).view(torch.bfloat16)
        step("one 2048 x 11008 bf16 transpose, torch (host)", lambda: t.t().contiguous())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
