"""chip_smoke.py refuses to report a result without a GPU, and without the
repository beside it; its [pipeline] phase runs on the CPU at a tiny size
(the card's synchronisation made a no-op, the launch floors left to the
card: the CPU path launches no kernel)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _run(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_chip_smoke_exits_nonzero_without_cuda():
    out = _run(ROOT, ROOT / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs an NVIDIA GPU" in out.stderr


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_main_raises_without_cuda(monkeypatch, capsys):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        chip_smoke.main()
    assert e.value.code != 0
    assert '"ok"' not in capsys.readouterr().out


@pytest.fixture
def one_torch_thread():
    """One intra-op thread: the tiny model's steps are many small ops, which
    threads only slow down when other test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_pipeline_phase_on_cpu(monkeypatch, one_torch_thread):
    """[pipeline] on padt_tiny in bf16: export (forced into 1 MiB shards and
    an index), convert, load both directories bit-equal, run_batch equal to
    a first run's completions, run_stream, infer over the phase's PNGs and
    both scores. The tiny config's fields that the HF config does not carry
    are passed to `load_model` as overrides."""
    import functools

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as C
    finally:
        sys.path.remove(str(ROOT))
    from padt_tpu_torch import api, padt_tiny
    from padt_tpu_torch.convert import padt_to_hf
    from padt_tpu_torch.eval.harness import InferenceEngine
    from padt_tpu_torch.models import padt as P

    cfg = padt_tiny()
    for name, value in (("GRID", (1, 8, 12)), ("PATCHES", 256), ("PROMPT_LEN", 256), ("NEW_TOKENS", 6)):
        monkeypatch.setattr(C, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(C, "check_launches", lambda *a, **k: None)
    monkeypatch.setattr(C, "check_serve_launches", lambda *a, **k: None)
    monkeypatch.setattr(padt_to_hf, "save_hf_checkpoint", functools.partial(padt_to_hf.save_hf_checkpoint, shard_size=1 << 20))
    load = api.load_model
    monkeypatch.setattr(api, "load_model", lambda path, **kw: load(
        path, pad_token_id=cfg.pad_token_id, max_image_patches=256, max_vrt_per_object=8, max_objects=8, **kw))
    params = P.init_padt_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    proc = C._processor(cfg)
    first = InferenceEngine(params, cfg, proc, max_new_tokens=6).run_batch(
        C.PROMPTS[: C.BATCH], [C._u8_image(i) for i in range(C.BATCH)], prompt_bucket=256)
    C.phase_pipeline(torch.device("cpu"), "CPU", cfg, params, proc, first)
