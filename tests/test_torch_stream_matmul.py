"""The port's streaming decode matmul (`padt_tpu_torch.ops.matmul`, H10's
plain version on the CPU) vs `padt_tpu.ops.matmul` on the same seeded numpy
inputs: the unfused XLA oracle `stream_matmul_stacked_ref` and the Pallas
kernel in TPU interpret mode, mirroring tests/test_stream_matmul.py; and
`tools/micro_stream_matmul.py --tiny`.

Tolerance: within 2^-7 of the output's largest magnitude (bf16 outputs; the
norm's 1 / rms is a division on one side and rsqrt on the other, and the sums
run in another order, so a value may land on the neighbouring bf16 number)."""

import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_common import jax_mode
from padt_tpu.ops import matmul as JM
from padt_tpu_torch.ops import cuda_matmul
from padt_tpu_torch.ops import matmul as TM

TOL = 2.0**-7


def _mk(nl, m, k, n, seed=0):
    """x (m, k), w (nl, k, n), ln (nl, k), b (nl, n) as bf16 values in fp32 numpy."""
    rng = np.random.RandomState(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return (bf(rng.randn(m, k) * 0.3), bf(rng.randn(nl, k, n) * 0.05), bf(1.0 + rng.randn(nl, k) * 0.1),
            bf(rng.randn(nl, n) * 0.1))


def _t(a):
    return torch.as_tensor(a).to(torch.bfloat16)


def _j(a):
    return jnp.asarray(a, jnp.bfloat16)


def _close(got, ref):
    a, r = got.float().numpy(), np.asarray(ref, np.float32)
    assert a.shape == r.shape, (a.shape, r.shape)
    assert np.abs(a - r).max() <= TOL * np.abs(r).max(), (float(np.abs(a - r).max()), float(np.abs(r).max()))


@pytest.mark.parametrize("fuse_ln,bias", [(True, True), (True, False), (False, False), (False, True)])
def test_stream_matmul_matches_jax(fuse_ln, bias):
    nl, m, k, n = 3, 16, 256, 512
    x, w, ln, b = _mk(nl, m, k, n)
    tkw = dict(ln_w=_t(ln) if fuse_ln else None, bias=_t(b) if bias else None)
    jkw = dict(ln_w=_j(ln) if fuse_ln else None, bias=_j(b) if bias else None)
    for li in (0, nl - 1):
        got = TM.stream_matmul_stacked(_t(x), _t(w), li, **tkw)
        assert got.dtype == torch.bfloat16 and got.shape == (m, n)
        _close(got, JM.stream_matmul_stacked_ref(_j(x), _j(w), li, **jkw))
        with jax_mode("pallas"):
            _close(got, JM.stream_matmul_stacked(_j(x), _j(w), jnp.int32(li), **jkw))


def test_stream_matmul_tensor_layer_index():
    """The layer as a 0-d tensor (JAX's traced index) gives the Python int's result."""
    nl, m, k, n = 4, 8, 128, 256
    x, w, ln, b = _mk(nl, m, k, n, seed=3)
    for li in range(nl):
        got = TM.stream_matmul_stacked(_t(x), _t(w), torch.tensor(li), ln_w=_t(ln), bias=_t(b))
        assert torch.equal(got, TM.stream_matmul_stacked(_t(x), _t(w), li, ln_w=_t(ln), bias=_t(b)))
        _close(got, JM.stream_matmul_stacked_ref(_j(x), _j(w), li, ln_w=_j(ln), bias=_j(b)))


def test_stream_matmul_odd_m_and_batch_shape():
    """M = 5 (no multiple of 8) and (B, 1, K) rows, as tests/test_stream_matmul.py."""
    nl, k, n = 2, 128, 256
    x, w, ln, _ = _mk(nl, 5, k, n, seed=7)
    got = TM.stream_matmul_stacked(_t(x), _t(w), 1, ln_w=_t(ln))
    _close(got, JM.stream_matmul_stacked_ref(_j(x), _j(w), 1, ln_w=_j(ln)))
    x3 = x.reshape(5, 1, k)
    got3 = TM.stream_matmul_stacked(_t(x3), _t(w), 0, ln_w=_t(ln))
    assert got3.shape == (5, 1, n)
    _close(got3, JM.stream_matmul_stacked_ref(_j(x3), _j(w), 0, ln_w=_j(ln)))
    with jax_mode("pallas"):
        _close(got3, JM.stream_matmul_stacked(_j(x3), _j(w), jnp.int32(0), ln_w=_j(ln)))


def test_cpu_calls_take_the_plain_version():
    nl, m, k, n = 2, 4, 64, 32
    x, w, ln, b = _mk(nl, m, k, n, seed=9)
    cuda_matmul.reset_launch_counts()
    TM.stream_matmul_stacked(_t(x), _t(w), 1, ln_w=_t(ln), bias=_t(b))
    assert cuda_matmul.launch_counts["stream_matmul"] == 0  # the plain version is no launch
    with pytest.raises(ValueError, match="CUDA"):
        cuda_matmul.stream_matmul(_t(x), _t(w), 1)


def test_micro_tool_tiny_runs_and_variants_agree(capsys):
    """tools/micro_stream_matmul.py --tiny: the three variants over padt_tiny's
    layers on the CPU agree within the tolerance, and no time is reported."""
    from padt_tpu_torch.tools import micro_stream_matmul as tool

    assert tool.main(["--tiny", "--b", "5"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["layers"] == 4 and res["b"] == 5 and not any(k.endswith("_ms") for k in res)
    for name in ("stream", "stream_noln"):
        assert res[f"max_gap_{name}"] <= TOL * res["max_abs_torch"]
    _, outs = tool.run(tool.padt_tiny().text, 5, "cpu", timed=False)
    assert all(o.shape == (5, 96) and bool(torch.isfinite(o.float()).all()) for o in outs.values())
