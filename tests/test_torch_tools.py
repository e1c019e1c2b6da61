"""PyTorch port's command-line tools (`padt_tpu_torch/tools/{convert_checkpoint,
demo,infer_eval,sft_train,process_datasets}.py`), run in-process on the CPU
(`--device cpu`).

The pipeline rehearsal is `scripts/real_weights_pipeline.sh`'s, on
`tests/test_pipeline_rehearsal.py`'s staged fixture (a tiny HF checkpoint
engineered to emit VRT tokens, a demo image, COCO and RefCOCO processed
JSONL; its missing decoder weights drawn once, by JAX, and exported with
the rest): convert (HF -> native, float32) -> `demo --check-golden` with the
VRT run that JAX's engine produces on the demo image -> COCO infer + score
-> RefCOCO infer + score. JAX runs the same stages in-process on the same
checkpoint in float32 (its engine with f32 pixel rows, around F1); the
port's completions equal JAX's, its predicted boxes and scores are JAX's
(scores within 1e-5), and its metrics are within 1e-6 of JAX's. The tiny
model's completions carry no label, so each side's predictions are also
scored relabelled with their image's ground-truth label (RefCOCO's cIoU
is then above 0; the random decoder's boxes stay below IoU 0.5)."""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_torch_common  # noqa: F401  (float32 products at full precision on the JAX side)
from test_datasets import _mk_coco
from test_pipeline_rehearsal import ROOT, staged  # noqa: F401  (the staged fixture)
from test_torch_datasets import mk_refer
from padt_tpu_torch.tools import convert_checkpoint, demo, infer_eval, process_datasets, sft_train


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's side: its tiny-model steps are
    many small ops, which threads only slow down when other test processes
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PROMPT = "the car is on the left side of the horse"
NEW = 8


def _jax_script(name):
    """A module of `scripts/` (not a package), loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_scripts_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_side(staged, tmp_path_factory):
    """JAX's float32 run of the same stages: the demo completion, and the
    COCO and RefCOCO scores of its predictions."""
    from types import SimpleNamespace

    import PIL.Image

    from padt_tpu.api import load_model
    from padt_tpu.eval.harness import InferenceEngine, infer_dataset
    from padt_tpu.preprocess.vision_process import ensure_min_28, resize_max_side
    from padt_tpu.train.data import load_jsonl_datasets

    from padt_tpu.convert.padt_to_hf import save_hf_checkpoint

    out = tmp_path_factory.mktemp("jax_out")
    # the staged checkpoint has no decoder weights, and each side would draw
    # its own: both run on JAX's tree, decoder included, exported to HF
    cfg, params, _ = load_model(staged["ckpt"], dtype=jnp.float32)
    ckpt = str(out / "full_ckpt")
    save_hf_checkpoint(ckpt, params, cfg, dtype="float32")
    with open(os.path.join(ckpt, "config.json")) as f:
        hf = json.load(f)
    with open(os.path.join(ckpt, "config.json"), "w") as f:  # the exporter leaves the pad id out
        json.dump(dict(hf, pad_token_id=cfg.pad_token_id), f)
    cfg, params, proc = load_model(ckpt, dtype=jnp.float32)
    img = ensure_min_28(PIL.Image.open(staged["demo_img"]).convert("RGB"))
    if max(img.size) > 644:
        img = resize_max_side(img, 644)
    # one engine for every stage: its compiled programs are reused where the shapes repeat
    engine = InferenceEngine(params, cfg, proc, max_new_tokens=NEW, compact_pixels=False)
    comp = engine.run_batch([PROMPT], [img])[0].completion
    score = _jax_script("infer_eval").cmd_score
    side = {"completion": comp, "ckpt": ckpt}
    for task, data, name in TASKS(staged):
        infer_dataset(engine, load_jsonl_datasets([data], [staged["imgdir"]]), str(out), batch_size=2,
                      datasetname=name, suffix="rehearsal")
        side[task + "_comp"] = _rows(out / f"{name}_0_pred_comp_rehearsal.json")
        side[task + "_pred"] = _rows(out / f"{name}_0_pred_results_rehearsal.json")
        _relabel(out / f"{name}_0_pred_results_rehearsal.json", data, out / f"{name}_0_pred_results_relabelled.json")
        for suffix in ("rehearsal", "relabelled"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                score(SimpleNamespace(task=task, pred_glob=str(out / f"{name}_*_pred_results_{suffix}.json"),
                                      processed_json=data, coco_json=staged["coco_json"]))
            text = buf.getvalue()
            side[f"{task}_{suffix}"] = json.loads(text[text.index("{"): text.rindex("}") + 1])
    return side


def TASKS(staged):
    return (("coco", staged["coco_jsonl"], "coco"),
            ("refcoco", os.path.join(staged["refdir"], "refcoco_val.jsonl"), "refcoco_val"))


def _rows(path):
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]


def _relabel(pred_path, data, out_path):
    """The predictions with each row's category set to its image's first
    ground-truth label."""
    label = {r["id"]: r["objects"][0]["label"] for r in _rows(data)}
    with open(out_path, "w") as f:
        for row in _rows(pred_path):
            f.write(json.dumps(dict(row, category=label[row["image_id"]])) + "\n")


def test_pipeline_rehearsal_matches_jax(staged, jax_side, tmp_path):
    vrts = re.findall(r"<\|VRT_(\d+)\|>", jax_side["completion"])
    assert vrts, f"the engineered checkpoint emitted no VRT tokens: {jax_side['completion']!r}"
    native = str(tmp_path / "native")
    assert convert_checkpoint.main(["--src", jax_side["ckpt"], "--dst", native, "--dtype", "float32"]) == 0

    # golden demo gate: the port must reproduce JAX's VRT run on the demo image
    args = ["--model", native, "--image", staged["demo_img"], "--prompt", PROMPT, "--max_new_tokens", str(NEW),
            "--output_dir", str(tmp_path / "demo"), "--device", "cpu", "--check-golden"]
    assert demo.main(args + ["--golden_vrts", ",".join(vrts)]) == 0
    comp = open(tmp_path / "demo" / "completion.txt").read()
    assert jax_side["completion"] in comp
    assert {"pred_box.png", "mask_seg.png", "vrt_seg.png"} <= set(os.listdir(tmp_path / "demo"))
    assert demo.main(args + ["--golden_vrts", "1,2,3,4,5,6,7"]) == 1  # the gate does fail

    out = tmp_path / "evals"
    for task, data, name in TASKS(staged):
        infer_eval.main(["infer", "--model", native, "--data", data, "--image_folder", staged["imgdir"],
                         "--dataset", name, "--batch_size", "2", "--max_new_tokens", str(NEW),
                         "--output_dir", str(out), "--suffix", "rehearsal", "--device", "cpu"])
        assert _rows(out / f"{name}_0_pred_comp_rehearsal.json") == jax_side[task + "_comp"]
        preds, jpreds = _rows(out / f"{name}_0_pred_results_rehearsal.json"), jax_side[task + "_pred"]
        assert len(preds) == len(jpreds) > 0
        for p, j in zip(preds, jpreds):
            assert (p["image_id"], p["category"], p["bbox"]) == (j["image_id"], j["category"], j["bbox"])
            assert abs(p["score"] - j["score"]) <= 1e-5
            assert ("mask" in p) == ("mask" in j)
        _relabel(out / f"{name}_0_pred_results_rehearsal.json", data, out / f"{name}_0_pred_results_relabelled.json")
        for suffix in ("rehearsal", "relabelled"):
            ours = infer_eval.main(["score", "--task", task, "--pred_glob",
                                    str(out / f"{name}_*_pred_results_{suffix}.json"), "--processed_json", data,
                                    "--coco_json", staged["coco_json"]])
            theirs = jax_side[f"{task}_{suffix}"]
            assert set(ours) == set(theirs)
            for k, v in theirs.items():
                assert abs(ours[k] - v) <= 1e-6, (task, suffix, k, ours[k], v)
    assert ours["ciou"] > 0, ours  # RefCOCO's relabelled masks overlap their ground truth


def test_infer_random_tiny_and_stream(staged, tmp_path):
    """`--model random:tiny` through both engines (fixed batches and the
    serve engine) writes one completion row per sample."""
    for engine in ("batch", "stream"):
        got = infer_eval.main(["infer", "--model", "random:tiny", "--data", staged["coco_jsonl"],
                               "--image_folder", staged["imgdir"], "--batch_size", "2", "--max_new_tokens", "4",
                               "--output_dir", str(tmp_path / engine), "--device", "cpu", "--engine", engine,
                               "--n_slots", "2", "--prefill_bucket", "2"])
        rows = [json.loads(l) for l in open(got["completions"])]
        assert [r["image_id"] for r in rows] == [1, 2]


def test_sft_train_tool_trains_and_checkpoints(staged, tmp_path):
    """Two steps of the SFT tool on the tiny checkpoint and a processed COCO
    file (`tests/test_datasets.py`'s directory); the trainer's checkpoint
    then converts to HF and loads back leaf-exact."""
    import PIL.Image

    from padt_tpu_torch.api import load_model

    src = _mk_coco(tmp_path)
    assert process_datasets.main(["coco", "--input", src, "--output", str(tmp_path / "ovd.jsonl")])["images"] == 1
    PIL.Image.fromarray(np.random.RandomState(0).randint(0, 255, (112, 140, 3), np.uint8)).save(tmp_path / "a.jpg")
    data = str(tmp_path / "ovd.jsonl")
    out = str(tmp_path / "sft")
    trainer = sft_train.main(["--model_name_or_path", staged["ckpt"], "--data_file_paths", f"{data}:{data}",
                              "--image_folders", f"{tmp_path}:{tmp_path}", "--output_dir", out,
                              "--per_device_train_batch_size", "1", "--num_train_epochs", "1", "--save_steps", "100",
                              "--max_pixels", "20000", "--device", "cpu"])
    assert trainer.global_step == 2
    metrics = [json.loads(l) for l in open(os.path.join(out, "metrics.jsonl"))]
    assert metrics and all(np.isfinite(m["loss"]) for m in metrics)
    ckpt = os.path.join(out, "checkpoint-2")
    assert convert_checkpoint.main(["--to-hf", "--src", ckpt, "--dst", str(tmp_path / "hf"), "--dtype", "float32"]) == 0
    _, a, _ = load_model(ckpt, device="cpu", use_mask_head=None)
    _, b, _ = load_model(str(tmp_path / "hf"), dtype=torch.float32, device="cpu", use_mask_head=None)

    def flat(t, p=""):
        return {k2: v2 for k, v in t.items() for k2, v2 in (flat(v, p + k + "/").items() if isinstance(v, dict) else [(p + k, v)])}

    fa, fb = flat(a), flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert torch.equal(fa[k].float(), fb[k]), k


def test_process_datasets_tool_matches_jax(tmp_path):
    from padt_tpu.preprocess import datasets as JD
    from padt_tpu.preprocess import refer_api as JR

    src = _mk_coco(tmp_path, with_captions=True)
    root = mk_refer(str(tmp_path / "data"))
    cases = [
        (["coco", "--input", src, "--train", "--seed", "1"], lambda o: JD.process_coco(src, o, is_train=True, seed=1)),
        (["refcoco", "--data_root", root, "--split", "val"], lambda o: JR.process_refcoco(root, "refcoco", "val", o)),
        (["ric", "--input", src], lambda o: JD.process_ric(src, o)),
    ]
    for i, (argv, jax_fn) in enumerate(cases):
        t_out, j_out = str(tmp_path / f"t{i}.jsonl"), str(tmp_path / f"j{i}.jsonl")
        assert process_datasets.main(argv + ["--output", t_out]) == jax_fn(j_out)
        assert open(t_out).read() == open(j_out).read() and os.path.getsize(t_out) > 0
