"""PyTorch port's `PaDTTrainer` vs `padt_tpu.train.trainer.PaDTTrainer` on
the CPU, on the fixture of tests/test_trainer.py (padt_tiny in float32, four
112x112 JPEG images with one box and one RLE mask each, bridged weights):
two optimizer steps plain and an in-training eval here (gradient
accumulation and the frozen tower's feature cache in
test_torch_train_accum.py, on the same fixture); then the port's save ->
resume against an uninterrupted run.

Tolerances: metrics 1e-5 relative (float32 on both sides); parameters
within lr / 10 absolute after two AdamW steps. Adam divides each gradient
element by its own RMS, so an element whose gradient is rounding noise on
both sides (e.g. a bias whose rows cancel) moves by up to lr in either
direction; every element with a real gradient agrees far closer."""

import json

import numpy as np
import pytest

import torch

from test_torch_common import tiny_params, torch_cfg
from padt_tpu.train import trainer as JT
from padt_tpu_torch.train import trainer as TT

LR = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import PIL.Image

    from padt_tpu.eval import rle as rle_codec
    from padt_tpu.preprocess.datasets import process_coco
    from padt_tpu.train.data import load_jsonl_datasets
    from padt_tpu_torch.train.data import load_jsonl_datasets as port_load

    tmp = tmp_path_factory.mktemp("torch_train")
    h = w = 112
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(4):
        images.append({"id": i, "file_name": f"im{i}.jpg", "height": h, "width": w})
        PIL.Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(tmp / f"im{i}.jpg")
        m = np.zeros((h, w), np.uint8)
        m[20 + 5 * i : 70, 20 : 70 - 3 * i] = 1
        r = rle_codec.encode(m)
        anns.append({"id": 100 + i, "image_id": i, "category_id": 1, "bbox": [20, 20 + 5 * i, 50 - 3 * i, 50 - 5 * i],
                     "area": 2500, "iscrowd": 0, "segmentation": {"size": r["size"], "counts": r["counts"]}})
    src = tmp / "instances.json"
    src.write_text(json.dumps({"images": images, "categories": [{"id": 1, "name": "cat"}], "annotations": anns}))
    out = tmp / "train.jsonl"
    process_coco(str(src), str(out))
    jdata = load_jsonl_datasets([str(out)], [str(tmp)])
    tdata = port_load([str(out)], [str(tmp)])
    assert tdata == jdata
    return jdata, tmp


def _procs(cfg):
    from padt_tpu.utils.mock_tokenizer import make_tiny_tokenizer
    from padt_tpu.vrt.processor import VisionTextProcessor
    from padt_tpu_torch.utils import mock_tokenizer as tmt
    from padt_tpu_torch.vrt import processor as tpr

    jp = VisionTextProcessor(make_tiny_tokenizer(cfg), cfg, seq_bucket=64, patch_bucket=cfg.max_image_patches)
    jp.prepare(cfg.text.vocab_size)
    tcfg = torch_cfg(cfg)
    tp = tpr.VisionTextProcessor(tmt.make_tiny_tokenizer(tcfg), tcfg, seq_bucket=64, patch_bucket=tcfg.max_image_patches)
    tp.prepare(tcfg.text.vocab_size)
    return jp, tp


def _args(mod, out, **kw):
    base = dict(learning_rate=LR, per_device_train_batch_size=2, num_train_epochs=1.0, save_steps=1000,
                use_mask_loss=True, prompt_bucket=256, completion_bucket=64, patch_bucket=256, canvas_hw=(8, 8), seed=0)
    base.update(kw)
    return mod.TrainArgs(output_dir=str(out), **base)


def _runs(setup, name, train=True, **kw):
    """The JAX trainer and the port's on the same data, args and weights."""
    data, tmp = setup
    cfg, jparams, tparams = tiny_params(0)
    jproc, tproc = _procs(cfg)
    jt = JT.PaDTTrainer(cfg, jparams, jproc, _args(JT, tmp / f"jax_{name}", **kw), data,
                        eval_dataset=data[2:] if kw.get("eval_strategy") else None)
    tt = TT.PaDTTrainer(torch_cfg(cfg), tparams, tproc, _args(TT, tmp / f"torch_{name}", **kw), data,
                        eval_dataset=data[2:] if kw.get("eval_strategy") else None, device="cpu")
    if train:
        return jt, tt, jt.train(), tt.train()
    return jt, tt, None, None


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _same_run(jt, tt, jlog, tlog, frozen=False):
    assert tt.global_step == jt.global_step == 2
    assert len(tlog) == len(jlog)
    for jm, tm in zip(jlog, tlog):
        assert set(tm) == set(jm)
        for k, v in jm.items():
            if k == "step_time_s":
                continue
            if isinstance(v, float):
                np.testing.assert_allclose(tm[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
            else:
                assert tm[k] == v, k
    jp = {k: np.asarray(v) for k, v in _flat(jt.params).items()}
    tp = {k: v.detach().numpy() for k, v in _flat(tt.params).items()}
    init = {k: v.numpy() for k, v in _flat(tiny_params(0)[2]).items()}
    assert set(tp) == set(jp)
    for k, b in jp.items():
        assert np.abs(tp[k] - b).max() <= LR / 10, (k, np.abs(tp[k] - b).max())
    assert sum(bool(np.abs(tp[k] - init[k]).max() > 0) for k in tp) > 20
    if frozen:
        assert all(np.array_equal(tp[k], init[k]) for k in tp if k.startswith("vision/"))


def test_trainer_matches_jax(setup):
    jt, tt, jlog, tlog = _runs(setup, "plain")
    _same_run(jt, tt, jlog, tlog)
    assert [m["warmup"] for m in tlog] == [True, False]  # epoch fraction 0, then 1/2 >= 1/4
    lines = [json.loads(x) for x in open(tt._metrics_file)]
    assert [x["step"] for x in lines] == [1, 2]


def test_trainer_eval_matches_jax(setup):
    jt, tt, _, _ = _runs(setup, "eval", train=False, eval_strategy="steps", eval_steps=1)
    jm, tm = jt.evaluate(), tt.evaluate()
    assert set(tm) == set(jm) and "eval_loss" in tm
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, err_msg=k)


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: the CPU's threaded index-add (the
    embedding's gradient) sums in an order that changes from run to run, so
    two runs agree to the bit only when both sum in one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resume_equals_uninterrupted_run(setup, one_thread):
    """Save after step 1, resume in a fresh trainer (other weights), train
    to step 2: bit for bit the same parameters, optimizer state and metrics
    as the run that went through."""
    data, tmp = setup
    cfg, _, _ = tiny_params(0)
    _, tproc = _procs(cfg)
    tcfg = torch_cfg(cfg)
    args = _args(TT, tmp / "resume", save_steps=1, random_select_patch=True)
    full = TT.PaDTTrainer(tcfg, tiny_params(0)[2], tproc, args, data, device="cpu")
    log = full.train()
    assert full.global_step == 2
    other = TT.PaDTTrainer(tcfg, tiny_params(1)[2], tproc, args, data, device="cpu")
    other.load_checkpoint(str(tmp / "resume" / "checkpoint-1"))
    assert other.global_step == 1
    log2 = other.train()
    assert [m["step"] for m in log2] == [2]
    for k in ("loss", "grad_norm", "sft_loss"):
        assert log2[0][k] == log[1][k], (k, log2[0][k], log[1][k])
    a, b = _flat(full.params), _flat(other.params)
    assert all(torch.equal(a[k].detach(), b[k].detach()) for k in a)
    sa, sb = full.optimizer.state_dict(), other.optimizer.state_dict()
    assert sa["count"] == sb["count"] == 2
    for i, st in sa["inner"]["state"].items():
        assert all(torch.equal(torch.as_tensor(v), torch.as_tensor(sb["inner"]["state"][i][n])) for n, v in st.items()), i
