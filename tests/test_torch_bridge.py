"""PyTorch port: the parameter bridge, the port's own init tree, and the
package's independence from JAX."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_common import tiny_params
from padt_tpu.config import padt_tiny
from padt_tpu.models import padt as JP
from padt_tpu_torch.convert.from_jax import params_from_numpy, params_to_numpy
from padt_tpu_torch.models import padt as TP

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


def test_pack_inference_params_matches_jax_key_for_key():
    """pack(bridge(p)) == bridge(JAX pack(p)): the same keys, shapes and
    values (a concatenation, exact); packing twice changes nothing."""
    cfg, jp, tp = tiny_params(2)
    ours = _flat(TP.pack_inference_params(tp))
    theirs = _flat(params_from_numpy(jax.tree.map(np.asarray, JP.pack_inference_params(jp))))
    assert set(ours) == set(theirs)
    assert {"text/layers/qkv_w", "text/layers/qkv_b", "text/layers/gateup_w"} <= set(ours)
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
    code = (
        "import sys\n"
        "import padt_tpu_torch.eval.harness, padt_tpu_torch.models.padt, padt_tpu_torch.convert.from_jax\n"
        "import padt_tpu_torch.ops.cuda_attention, padt_tpu_torch.ops._build\n"
        "import padt_tpu_torch.ops.cuda_kv, padt_tpu_torch.ops.kv_cache, padt_tpu_torch.serve\n"
        "print('jax' in sys.modules)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_package_uses_no_jax_and_no_library_attention():
    banned = ("import jax", "from jax", "scaled_dot_product_attention", "torch.compile", "flash_attn", "xformers")
    for path in list((ROOT / "padt_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        text = path.read_text()
        for word in banned:
            assert word not in text, (path, word)
