"""PyTorch port: the parameter bridge, the port's own init trees (dense and
int8), the int8 parameter transforms against JAX's, and the package's
independence from JAX and from the JAX package."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_common import tiny_params, torch_cfg
from padt_tpu.config import padt_tiny
from padt_tpu.models import padt as JP
from padt_tpu_torch.convert.from_jax import params_from_numpy, params_to_numpy
from padt_tpu_torch.models import padt as TP
from padt_tpu_torch.models.vision import pack_vision_blocks

ROOT = Path(__file__).resolve().parents[1]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_bridge_round_trips_every_key(dtype):
    cfg = padt_tiny()
    jp = JP.init_padt_params(cfg, jax.random.PRNGKey(3), dtype)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    jf, tf = _flat(jp), _flat(tp)
    assert set(jf) == set(tf)
    want = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    back = _flat(params_to_numpy(tp))
    for k, v in jf.items():
        assert tuple(tf[k].shape) == v.shape, k
        assert tf[k].dtype == want, k
        np.testing.assert_array_equal(back[k], np.asarray(v, np.float32), err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_tree_matches_jax_keys_shapes_dtypes(dtype):
    cfg = padt_tiny()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jf = _flat(jax.eval_shape(lambda k: JP.init_padt_params(cfg, k, jdt), jax.random.PRNGKey(0)))
    tf = _flat(TP.init_padt_params(cfg, torch.Generator().manual_seed(0), "cpu", dtype))
    assert set(jf) == set(tf)
    for k, v in jf.items():
        assert tuple(tf[k].shape) == v.shape, k
        assert tf[k].dtype == dtype, k


def _jax_packed(jp):
    """bridge(JAX pack(p)), its tower's blocks then in the port's serving
    layout (JAX's tree keeps the plain tower; `test_torch_vision_packed.py`
    holds that layout against the plain leaves)."""
    tree = params_from_numpy(jax.tree.map(np.asarray, JP.pack_inference_params(jp)))
    tree["vision"] = dict(tree["vision"], blocks=pack_vision_blocks(tree["vision"]["blocks"]))
    return tree


def test_pack_inference_params_matches_jax_key_for_key():
    """pack(bridge(p)) == bridge(JAX pack(p)), the tower packed by the port's
    rule: the same keys, shapes and values (a concatenation, exact);
    packing twice changes nothing."""
    cfg, jp, tp = tiny_params(2)
    ours = _flat(TP.pack_inference_params(tp))
    theirs = _flat(_jax_packed(jp))
    assert set(ours) == set(theirs)
    assert {"text/layers/qkv_w", "text/layers/qkv_b", "text/layers/gateup_w", "vision/blocks/gateup_w"} <= set(ours)
    assert not {"text/layers/q_w", "text/layers/up_w"} & set(ours)
    for k, v in theirs.items():
        assert torch.equal(ours[k], v), k
    packed = TP.pack_inference_params(tp)
    assert TP.pack_inference_params(packed) is packed
    assert "q_w" in tp["text"]["layers"]  # the input tree is left as it was


def test_padt_model_holds_the_tree():
    cfg, _, tp = tiny_params(0)
    model = TP.PaDTModel(cfg, tp)
    held = _flat(model.params)
    assert set(held) == set(_flat(tp))
    assert all(held[k] is v for k, v in _flat(tp).items())
    assert len(model.state_dict()) == len(held)


def test_import_leaves_jax_out():
    """Every module of the port (its training modules, checkpoint I/O,
    scorers, preprocessing and tools included), and chip_smoke as a module
    (main not run), imports none of jax, optax, orbax or padt_tpu, and none
    of the optional packages the card need not have: safetensors,
    transformers, cv2, PIL, ml_dtypes."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import padt_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(padt_tpu_torch.__path__, 'padt_tpu_torch.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'optax', 'orbax', 'padt_tpu',\n"
        "             'safetensors', 'transformers', 'cv2', 'PIL', 'ml_dtypes'))\n"
        "print(len(names), bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 45 and bad == "[]", out.stdout


def test_sources_import_nothing_of_padt_tpu():
    """A source scan: no import statement of the port or of chip_smoke.py
    names padt_tpu or a module of it."""
    pat = re.compile(r"^\s*(from\s+padt_tpu(\.|\s)|import\s+padt_tpu(\.|\s|,|$))|import_module\(\s*[\"']padt_tpu[\"'.]", re.M)
    paths = list((ROOT / "padt_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(paths) >= 30
    for path in paths:
        hits = pat.findall(path.read_text())
        assert not hits, (path, hits)


def test_package_uses_no_jax_and_no_library_attention():
    """Neither the package nor chip_smoke.py uses JAX or compiled or packaged
    kernels; the package calls no library attention or int8 GEMM either
    (chip_smoke.py times those beside the kernels as yardsticks)."""
    banned = ("import jax", "from jax", "import optax", "from optax", "import orbax", "from orbax", "torch.compile", "flash_attn", "xformers")
    library = ("scaled_dot_product_attention", "_weight_int8pack_mm", "_int_mm", "cublas")
    for path in list((ROOT / "padt_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        text = path.read_text()
        for word in banned + (library if path.name != "chip_smoke.py" else ()):
            assert word not in text, (path, word)
    for path in (ROOT / "padt_tpu_torch" / "csrc").glob("*.cu*"):
        text = path.read_text().lower()
        assert "cublas" not in text and "cutlass/gemm" not in text, path


# ---------------------------------------------------------------------------
# int8 text-layer weights
# ---------------------------------------------------------------------------

def _assert_same_tree(ours, theirs):
    """The same keys, shapes and dtypes; int8 leaves equal or one quantum
    apart at a rounding tie, fp32 scales within 1e-6 relative, every other
    leaf equal."""
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert ours[k].shape == v.shape and ours[k].dtype == v.dtype, k
        if v.dtype == torch.int8:
            d = (ours[k].int() - v.int()).abs()
            assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 1e-3, k
        elif k.endswith("_s"):
            torch.testing.assert_close(ours[k], v, rtol=1e-6, atol=0, msg=k)
        else:
            assert torch.equal(ours[k], v), k


@pytest.mark.parametrize("packed", [False, True])
def test_quantize_and_pack_match_jax_key_for_key(packed):
    """quantize_params (then the int8 branch of pack_inference_params) on the
    bridged tree == the bridged JAX result (packed: the tower in the port's
    serving layout); packing twice changes nothing."""
    cfg, jp, tp = tiny_params(5)
    jq, tq = JP.quantize_params(jp), TP.quantize_params(tp)
    if packed:
        tq = TP.pack_inference_params(tq)
        assert TP.pack_inference_params(tq) is tq
    ours = _flat(tq)
    _assert_same_tree(ours, _flat(_jax_packed(jq) if packed else params_from_numpy(jax.tree.map(np.asarray, jq))))
    names = ("qkv_w", "o_w", "gateup_w", "down_w") if packed else ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")
    for n in names:
        assert ours[f"text/layers/{n}_q"].dtype == torch.int8 and ours[f"text/layers/{n}_s"].dtype == torch.float32
        assert f"text/layers/{n}" not in ours
    assert "q_w" in tp["text"]["layers"]  # the input tree is left as it was


@pytest.mark.parametrize("packed", [False, True])
def test_init_quantized_tree_matches_jax(packed):
    """init_padt_params_quantized: JAX's keys, shapes and dtypes
    (jax.eval_shape), int8 values filling [-127, 127], scales 0.02 / 73."""
    cfg = padt_tiny()
    jf = _flat(jax.eval_shape(lambda k: JP.init_padt_params_quantized(cfg, k, jnp.float32, packed=packed), jax.random.PRNGKey(0)))
    tree = TP.init_padt_params_quantized(torch_cfg(cfg), torch.Generator().manual_seed(0), "cpu", torch.float32, packed=packed)
    tf = _flat(tree)
    assert set(jf) == set(tf)
    for k, v in jf.items():
        assert tuple(tf[k].shape) == v.shape, k
        assert str(tf[k].dtype).split(".")[-1] == str(v.dtype), k
    q = tf["text/layers/o_w_q"]
    assert int(q.min()) == -127 and int(q.max()) == 127
    assert torch.all(tf["text/layers/down_w_s"] == np.float32(0.02 / 73.0))


@pytest.mark.parametrize("packed", [False, True])
def test_bridge_keeps_int8_leaves(packed):
    """int8 values and fp32 scales cross the bridge unchanged, both ways."""
    cfg, jp, _ = tiny_params(6)
    jq = JP.quantize_params(jp)
    if packed:
        jq = JP.pack_inference_params(jq)
    jf = _flat(jq)
    tf = _flat(params_from_numpy(jax.tree.map(np.asarray, jq)))
    back = _flat(params_to_numpy(params_from_numpy(jax.tree.map(np.asarray, jq))))
    quant = [k for k in jf if k.endswith("_q") or k.endswith("_s")]
    assert len(quant) == (8 if packed else 14)
    for k in quant:
        want = torch.int8 if k.endswith("_q") else torch.float32
        assert tf[k].dtype == want, k
        np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]), err_msg=k)
        assert back[k].dtype == np.asarray(jf[k]).dtype
        np.testing.assert_array_equal(back[k], np.asarray(jf[k]), err_msg=k)
