"""The port's int8 weight quantization (`padt_tpu_torch.ops.quant`: the
quantizer, H7's plain twin and `linear`) vs `padt_tpu.ops.quant` on the CPU,
on the same seeded numpy inputs.

quantize_weight: int8 values equal to JAX's, or one quantum apart where
w / s lands within float32 rounding of a half (a rounding tie); scales
within 1e-6 relative. int8_matmul: against JAX's plain float32 branch
(PADT_PALLAS=0) at 1e-5 relative to the output's magnitude (only the order
of sums differs, and JAX scales the weight before the product where the
port scales the sum); against the Pallas kernel in TPU interpret mode with
bf16 inputs at 2e-2 absolute (bf16 output rounding of values of magnitude
~1, and another order of sums)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_common import jax_mode
from padt_tpu.ops import quant as JQ
from padt_tpu_torch.ops import quant as TQ

T = lambda a: torch.as_tensor(np.array(a))


def _weight(k, n, seed):
    """Seeded float32 (K, N) weights with an all-zero column (the 1e-12 scale
    floor) and a column of exact rounding ties (scale 1, half-integer values)."""
    w = (np.random.RandomState(seed).randn(k, n) * 0.05).astype(np.float32)
    w[:, 3] = 0.0
    w[:, 5] = np.arange(k) % 9 - 4.5
    w[0, 5] = 127.0
    return w


def _assert_same_quant(tq, ts, jq, js):
    tq, jq = tq.numpy().astype(np.int32), np.asarray(jq).astype(np.int32)
    d = np.abs(tq - jq)
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)


@pytest.mark.parametrize("k,n", [(96, 256), (128, 96), (96, 320), (160, 96)])
def test_quantize_weight_matches_jax(k, n):
    """The tiny model's four weight shapes (qkv, o, gate|up, down)."""
    w = _weight(k, n, k + n)
    jd = JQ.quantize_weight(jnp.asarray(w))
    td = TQ.quantize_weight(T(w))
    assert td["q"].dtype == torch.int8 and tuple(td["q"].shape) == (k, n)
    assert td["s"].dtype == torch.float32 and tuple(td["s"].shape) == (1, n)
    _assert_same_quant(td["q"], td["s"], jd["q"], jd["s"])
    assert float(td["s"][0, 3]) == np.float32(1e-12) and torch.all(td["q"][:, 3] == 0)
    # round half to even on the exact ties of column 5 (scale exactly 1)
    np.testing.assert_array_equal(td["q"][1:, 5].numpy(), np.round(w[1:, 5]).astype(np.int8))


def _matmul_inputs(lead, k, n, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    x = rng.randn(*lead, k).astype(dtype)
    wq = rng.randint(-127, 128, (k, n)).astype(np.int8)
    s = rng.lognormal(-4.0, 0.3, (1, n)).astype(np.float32)
    return x, wq, s


@pytest.mark.parametrize("lead,k,n", [((3, 5), 96, 160), ((7,), 96, 64), ((2, 1), 160, 96), ((4, 8), 128, 320)])
def test_int8_matmul_plain_matches_jax_f32(lead, k, n):
    x, wq, s = _matmul_inputs(lead, k, n, k * n)
    with jax_mode("xla"):
        ref = np.asarray(JQ.int8_matmul(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s)))
    out = TQ.int8_matmul(T(x), T(wq), T(s))  # CPU tensors: the plain twin
    assert out.dtype == torch.float32 and tuple(out.shape) == (*lead, n)
    np.testing.assert_array_equal(out.numpy(), TQ.int8_matmul_plain(T(x), T(wq), T(s)).numpy())
    err = np.abs(out.numpy().astype(np.float64) - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


@pytest.mark.parametrize("lead,k,n", [((3, 5), 96, 160), ((8,), 128, 96)])
def test_int8_matmul_plain_matches_pallas_bf16(lead, k, n):
    """N = 160 and 96 are padded to 128 multiples by the TPU kernel, M = 15
    to its 8-row block."""
    x, wq, s = _matmul_inputs(lead, k, n, k + n)
    x = (x * 0.05).astype(np.float32)  # outputs of magnitude ~1
    xb = jnp.asarray(x, jnp.bfloat16)
    with jax_mode("pallas"):
        ref = np.asarray(JQ.int8_matmul(xb, jnp.asarray(wq), jnp.asarray(s)).astype(jnp.float32))
    out = TQ.int8_matmul(T(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16), T(wq), T(s))
    assert out.dtype == torch.bfloat16
    assert 0.3 < np.abs(ref).max() < 10
    assert np.abs(out.float().numpy() - ref).max() <= 2e-2


def test_linear_takes_int8_weights_when_present():
    """`linear` goes through int8_matmul for `{name}_q` / `{name}_s` and is
    a plain product otherwise, like JAX's."""
    x, wq, s = _matmul_inputs((2, 3), 96, 64, 1)
    w = (np.random.RandomState(2).randn(96, 64) * 0.05).astype(np.float32)
    jlp = {"o_w_q": jnp.asarray(wq), "o_w_s": jnp.asarray(s), "up_w": jnp.asarray(w)}
    tlp = {"o_w_q": T(wq), "o_w_s": T(s), "up_w": T(w)}
    with jax_mode("xla"):
        for name in ("o_w", "up_w"):
            ref = np.asarray(JQ.linear(jlp, name, jnp.asarray(x)))
            out = TQ.linear(tlp, name, T(x)).numpy()
            assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max(), name
