"""PyTorch port: checkpoints in and out, against the `safetensors` package
and the JAX package, on the CPU.

  - `convert/safetensors_io` reads what `safetensors.numpy.save_file` and
    `safetensors.torch.save_file` write (every supported dtype, one file and
    a sharded directory with its index), and the package reads what it
    writes: every tensor bit-equal;
  - on `tests/test_api.py`'s HF fixture (a `save_pretrained` directory, no
    download), `api.load_model` gives JAX's `load_model(dtype=float32)`
    tree leaf for leaf, exactly (the random decoder a stock checkpoint
    lacks: keys, shapes and dtypes only, since JAX draws it from another
    generator), and a PaDT directory with every leaf (JAX's
    `save_hf_checkpoint` of that tree) loads to JAX's whole tree exactly;
    a tiny `run_batch` on it is token-exact with JAX's (any parsed
    object's score within 1e-5 and box within a pixel);
  - HF -> native -> `load_model` and HF -> `--to-hf` -> `load_model`
    (`tools/convert_checkpoint`) are leaf-exact; bf16 stays bf16 on disk.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import torch

from padt_tpu_torch.convert import safetensors_io as sio


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's side: its tiny-model steps are
    many small ops, which threads only slow down when other test processes
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_NP = {
    "BF16": ml_dtypes.bfloat16, "F16": np.float16, "F32": np.float32, "F64": np.float64, "I8": np.int8,
    "U8": np.uint8, "I16": np.int16, "I32": np.int32, "I64": np.int64, "BOOL": np.bool_,
}
_TORCH = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "F64": torch.float64, "I8": torch.int8,
    "U8": torch.uint8, "I16": torch.int16, "I32": torch.int32, "I64": torch.int64, "BOOL": torch.bool,
}
SHAPES = [(3, 5), (7,), (), (0, 4), (2, 3, 4)]


def _arrays(seed):
    """name -> numpy array, one per dtype tag and shape (bf16 via ml_dtypes)."""
    r = np.random.RandomState(seed)
    out = {}
    for tag, dt in _NP.items():
        for i, shp in enumerate(SHAPES):
            if tag == "BOOL":
                a = r.rand(*shp) > 0.5
            elif tag in ("BF16", "F16", "F32", "F64"):
                a = (np.asarray(r.randn(*shp)) * 100).astype(np.float32).astype(dt)
            else:
                info = np.iinfo(dt)
                a = r.randint(info.min, info.max, size=shp, dtype=np.int64).astype(dt)
            out[f"t.{tag}.{i}"] = np.asarray(a, dt)
    return out


def _bits(a):
    """Comparable bits: bf16 arrays (ml_dtypes, or this package's uint16) as uint16."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same_bits(ours, theirs):
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        a, b = _bits(ours[k]), _bits(v)
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


def _torch_tensors(seed):
    """name -> torch tensor, one per dtype tag and shape."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for tag, dt in _TORCH.items():
        for i, shp in enumerate(SHAPES):
            if dt == torch.bool:
                t = torch.rand(shp, generator=g) > 0.5
            elif dt.is_floating_point:
                t = (torch.randn(shp, generator=g) * 100).to(dt)
            else:
                t = torch.randint(-100, 100, shp, generator=g).to(dt)
            out[f"t.{tag}.{i}"] = t
    return out


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("writer", ["numpy", "torch"])
def test_reads_what_the_safetensors_package_writes(tmp_path, writer, sharded):
    """Every dtype tag at five shapes (a scalar and an empty tensor among
    them), written by `safetensors.numpy.save_file` or
    `safetensors.torch.save_file` as one file or two shards with the HF
    index: `load_dir` reads each tensor bit-equal, and `to_torch` /
    `from_torch` carry bf16 by its bits."""
    if writer == "numpy":
        from safetensors.numpy import save_file

        tensors = _arrays(0)
        want = {k: _bits(v) for k, v in tensors.items()}
    else:
        from safetensors.torch import save_file

        tensors = _torch_tensors(1)
        want = {k: _bits(sio.from_torch(v)) for k, v in tensors.items()}
    names = sorted(tensors)
    parts = [names[: len(names) // 2], names[len(names) // 2 :]] if sharded else [names]
    index = {"metadata": {}, "weight_map": {}}
    for j, part in enumerate(parts):
        fname = f"model-{j + 1:05d}-of-{len(parts):05d}.safetensors" if sharded else "model.safetensors"
        save_file({k: tensors[k] for k in part}, str(tmp_path / fname), metadata={"format": writer})
        index["weight_map"].update({k: fname for k in part})
    if sharded:
        (tmp_path / sio.INDEX_NAME).write_text(json.dumps(index))
    got = sio.load_dir(str(tmp_path))
    _same_bits(got, want)
    assert got["t.BF16.0"].dtype == np.uint16  # bf16 as its bits
    assert sio.read_header(str(tmp_path / fname))[1] == {"format": writer}
    if writer == "torch":
        for k, t in tensors.items():
            back = sio.to_torch(got[k])
            assert back.dtype == t.dtype and back.shape == t.shape, k
            same = torch.equal(back.view(torch.int16), t.view(torch.int16)) if t.dtype == torch.bfloat16 else torch.equal(back, t)
            assert same, k


def test_safetensors_reads_what_the_port_writes(tmp_path):
    from safetensors import safe_open

    arrays = _arrays(2)
    sio.save_file(arrays, str(tmp_path / "b.safetensors"), metadata={"who": "port"})
    with safe_open(str(tmp_path / "b.safetensors"), framework="numpy") as f:
        assert f.metadata() == {"who": "port"}
        theirs = {k: f.get_tensor(k) for k in f.keys()}
    _same_bits(theirs, arrays)
    with safe_open(str(tmp_path / "b.safetensors"), framework="pt") as f:
        assert f.get_tensor("t.BF16.0").dtype == torch.bfloat16
    # the package's own reader round trip, and the header's 8-byte padding
    _same_bits(sio.load_file(str(tmp_path / "b.safetensors")), arrays)
    n = int.from_bytes((tmp_path / "b.safetensors").read_bytes()[:8], "little")
    assert n % 8 == 0


# ---------------------------------------------------------------------------
# load_model against the JAX package on tests/test_api.py's fixture
# ---------------------------------------------------------------------------

OVERRIDES = dict(max_image_patches=128, eos_token_id=510, pad_token_id=509)


def _save_hf_fixture(d, padt_extras=True):
    """`tests/test_api.py`'s tiny Qwen2.5-VL directory from `save_pretrained`;
    with padt_extras, its config carries the PaDT decoder dict and turns the
    prototype projection off (as that fixture does)."""
    from transformers.models.qwen2_5_vl.configuration_qwen2_5_vl import Qwen2_5_VLConfig
    from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import Qwen2_5_VLForConditionalGeneration

    cfg = Qwen2_5_VLConfig(
        text_config=dict(
            vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, intermediate_size=96, tie_word_embeddings=True,
            rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
        ),
        vision_config=dict(
            depth=2, hidden_size=32, intermediate_size=64, num_heads=2,
            out_hidden_size=64, fullatt_block_indexes=[1], spatial_merge_size=2,
        ),
        image_token_id=500, video_token_id=501, vision_start_token_id=498,
        tie_word_embeddings=True,
    )
    if padt_extras:
        cfg.vl_decoder = {
            "name": "PaDTDecoder", "hidden_size": 32, "intermediate_size": 64,
            "llm_hidden_state": 64, "num_heads": 2, "spatial_merge_size": 2,
            "use_mask_loss": True,
        }
        cfg.use_visual_prototype_projection = False
    torch.manual_seed(0)
    model = Qwen2_5_VLForConditionalGeneration(cfg)
    with torch.no_grad():  # text weights large enough for varied greedy tokens
        for p in model.model.language_model.layers.parameters():
            p.mul_(5.0)
    model.save_pretrained(d, safe_serialization=True)
    return str(d)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """{"stock": Qwen2.5-VL only, "fixture": with the PaDT config, "full": a
    PaDT directory with every leaf, written by JAX's exporter}."""
    from padt_tpu.api import load_model as jax_load
    from padt_tpu.convert.padt_to_hf import save_hf_checkpoint as jax_save

    root = tmp_path_factory.mktemp("ckpt")
    dirs = {"fixture": _save_hf_fixture(root / "fixture"), "stock": _save_hf_fixture(root / "stock", False)}
    cfg, params, _ = jax_load(dirs["fixture"], dtype=jnp.float32, **OVERRIDES)
    dirs["full"] = str(root / "full")
    jax_save(dirs["full"], params, cfg, dtype="float32")
    return dirs


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _jax_tree(path):
    from padt_tpu.api import load_model as jax_load

    cfg, params, proc = jax_load(path, dtype=jnp.float32, **OVERRIDES)
    return cfg, {k: np.asarray(v) for k, v in _flat(params).items()}, proc


def _port_tree(path, **kw):
    from padt_tpu_torch.api import load_model

    cfg, params, proc = load_model(path, dtype=torch.float32, device="cpu", **OVERRIDES, **kw)
    return cfg, params, proc


def _assert_leaves_equal(tp, jf, keys):
    tf = _flat(tp)
    for k in keys:
        assert tf[k].dtype == torch.float32 and tf[k].device.type == "cpu", k
        np.testing.assert_array_equal(tf[k].numpy(), jf[k], err_msg=k)


@pytest.mark.parametrize("which", ["fixture", "stock"])
def test_load_model_matches_jax_tree(hf_dirs, which):
    jcfg, jf, _ = _jax_tree(hf_dirs[which])
    cfg, tp, proc = _port_tree(hf_dirs[which])
    assert json.loads(cfg.to_json()) == json.loads(jcfg.to_json())
    tf = _flat(tp)
    assert set(tf) == set(jf)
    for k, v in jf.items():
        assert tuple(tf[k].shape) == v.shape and str(tf[k].dtype).split(".")[-1] == str(v.dtype), k
    # converted leaves exactly; the PaDT extras a stock checkpoint lacks are
    # drawn from a seeded generator on each side (other values)
    converted = [k for k in jf if k.split("/")[0] in ("vision", "text")]
    assert len(converted) > 20
    _assert_leaves_equal(tp, jf, converted)
    if which == "stock":
        assert cfg.use_visual_prototype_projection and "proto" in tp and "decoder" in tp
        assert torch.all(tp["proto"]["ln_w"] == 0)
    assert proc.tokenizer is not None and len(proc.tokenizer) >= cfg.text.vocab_size - 16


def test_load_model_full_tree_and_run_batch_match_jax(hf_dirs):
    from padt_tpu.eval.harness import InferenceEngine as JEngine
    from padt_tpu.preprocess.vision_process import ProcessedImage as JImage
    from padt_tpu_torch.eval.harness import InferenceEngine as TEngine
    from padt_tpu_torch.preprocess.vision_process import ProcessedImage as TImage

    jcfg, jf, jproc = _jax_tree(hf_dirs["full"])
    cfg, tp, proc = _port_tree(hf_dirs["full"])
    assert set(_flat(tp)) == set(jf) and "decoder" in tp
    _assert_leaves_equal(tp, jf, list(jf))

    from padt_tpu.api import load_model as jax_load

    _, jparams, _ = jax_load(hf_dirs["full"], dtype=jnp.float32, **OVERRIDES)
    rows = np.random.RandomState(0).randn(96, 1176).astype(np.float32)
    prompts = ['find "x"', 'where is "the cat"']
    jres = JEngine(jparams, jcfg, jproc, max_new_tokens=6, canvas_hw=(8, 12)).run_batch(
        prompts, [JImage(rows, (1, 8, 12)), JImage(rows[::-1].copy(), (1, 8, 12))])
    tres = TEngine(tp, cfg, proc, max_new_tokens=6, canvas_hw=(8, 12)).run_batch(
        prompts, [TImage(rows, (1, 8, 12)), TImage(rows[::-1].copy(), (1, 8, 12))])
    assert [r.completion for r in tres] == [r.completion for r in jres]
    for t, j in zip(tres, jres):
        assert [o.vrt_string for o in t.objects] == [o.vrt_string for o in j.objects]
        for to, jo in zip(t.objects, j.objects):
            assert abs(to.score - jo.score) <= 1e-5
            np.testing.assert_allclose(to.bbox_xywh_px, jo.bbox_xywh_px, atol=1.0)


def _convert(*argv):
    from padt_tpu_torch.tools import convert_checkpoint

    assert convert_checkpoint.main([*argv, "--device", "cpu"]) == 0


@pytest.mark.parametrize("route", ["native", "to_hf"])
def test_conversion_round_trips_are_leaf_exact(hf_dirs, tmp_path, route):
    src = hf_dirs["full"]
    dst = str(tmp_path / route)
    if route == "native":
        _convert("--src", src, "--dst", dst, "--dtype", "float32")
        assert sorted(os.listdir(dst)) == ["padt_config.json", "params.pt"]
    else:
        _convert("--to-hf", "--src", src, "--dst", dst, "--dtype", "float32")
        assert "config.json" in os.listdir(dst)
    _, a, _ = _port_tree(src, use_mask_head=None)
    cfg_b, b, _ = _port_tree(dst, use_mask_head=None)
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_bf16_stays_bf16_through_export(hf_dirs, tmp_path):
    """bf16 leaves leave as BF16 tensors (several shards and the index here) and
    load back bit-equal; the HF -> native default dtype is bf16."""
    from padt_tpu_torch.convert.padt_to_hf import save_hf_checkpoint

    cfg, tp, _ = _port_tree(hf_dirs["full"])
    bf = jax.tree.map(lambda t: t.to(torch.bfloat16), tp)
    total = sum(t.numel() * 2 for t in _flat(bf).values())
    save_hf_checkpoint(str(tmp_path / "bf"), bf, cfg, shard_size=total // 2 + 1)
    index = json.loads((tmp_path / "bf" / sio.INDEX_NAME).read_text())
    shards = sorted(set(index["weight_map"].values()))
    assert len(shards) >= 2 and sorted(os.listdir(tmp_path / "bf")) == sorted(["config.json", sio.INDEX_NAME, *shards])
    for name in shards:
        header, _, _ = sio.read_header(str(tmp_path / "bf" / name))
        assert {v["dtype"] for v in header.values()} == {"BF16"}
    from padt_tpu_torch.api import load_model

    _, back, _ = load_model(str(tmp_path / "bf"), device="cpu", use_mask_head=None)
    fa, fb = _flat(bf), _flat(back)
    assert set(fa) == set(fb)
    for k in fa:
        assert fb[k].dtype == torch.bfloat16 and torch.equal(fa[k], fb[k]), k
    _convert("--src", str(tmp_path / "bf"), "--dst", str(tmp_path / "nat"))
    _, nat, _ = load_model(str(tmp_path / "nat"), device="cpu", use_mask_head=None)
    for k, v in _flat(nat).items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, fa[k]), k


def test_load_tokenizer_skips_transformers_without_tokenizer_files(tmp_path):
    """A directory with no tokenizer or vocab file gives None without
    importing `transformers`; one with a (broken) tokenizer file is tried
    through `transformers` and, failing, gives None too."""
    import subprocess
    import sys

    (tmp_path / "config.json").write_text("{}")
    code = ("import sys; from padt_tpu_torch.api import load_tokenizer; "
            f"assert load_tokenizer({str(tmp_path)!r}) is None; print('transformers' in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root, timeout=120,
                         env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr
    from padt_tpu_torch.api import load_tokenizer

    (tmp_path / "tokenizer_config.json").write_text("not json")
    assert load_tokenizer(str(tmp_path)) is None


@pytest.mark.parametrize("untied", [False, True])
def test_export_state_dict_and_hf_config_match_jax(untied):
    """The port's `export_state_dict` of the bridged tree is JAX's of the JAX
    tree (every key, shape and value), and `hf_config_from_padt` /
    `config_from_hf` agree, on padt_tiny tied and untied (the 7B layout)."""
    import dataclasses

    from padt_tpu.config import padt_tiny
    from padt_tpu.convert import hf_to_padt as JH, padt_to_hf as JE
    from padt_tpu.models import padt as JP
    from padt_tpu_torch.convert import hf_to_padt as TH, padt_to_hf as TE
    from padt_tpu_torch.convert.from_jax import params_from_numpy
    from test_torch_common import torch_cfg

    cfg = padt_tiny()
    if untied:
        cfg = cfg.replace(text=dataclasses.replace(cfg.text, tie_word_embeddings=False))
    jp = JP.init_padt_params(cfg, jax.random.PRNGKey(4), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    host = lambda t: {k: host(v) if isinstance(v, dict) else sio.from_torch(v) for k, v in t.items()}
    ours, theirs = TE.export_state_dict(host(tp), torch_cfg(cfg)), JE.export_state_dict(jax.tree.map(np.asarray, jp), cfg)
    assert set(ours) == set(theirs) and ("lm_head.weight" in ours) == untied
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    hf = TE.hf_config_from_padt(torch_cfg(cfg))
    assert hf == JE.hf_config_from_padt(cfg)
    assert json.loads(TH.config_from_hf(hf).to_json()) == json.loads(JH.config_from_hf(hf).to_json())
