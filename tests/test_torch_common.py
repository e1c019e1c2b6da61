"""Shared set-up for the PyTorch-port parity tests (tests/test_torch_*.py),
the tiny config in float32, one random JAX parameter tree bridged to torch by
key, and seeded host batches that feed both sides the same numpy inputs.

Each side gets its own package's objects: the JAX config, processor and
images for JAX, and their field-for-field copies from `padt_tpu_torch` for
the port (`torch_cfg`, `tiny_processor(torch_cfg(cfg))`, `port_image`)."""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np

import jax
import jax.numpy as jnp
import torch

from padt_tpu.config import padt_tiny
from padt_tpu.preprocess.vision_process import ProcessedImage, expand_u8_rows
from padt_tpu.utils.mock_tokenizer import make_tiny_tokenizer
from padt_tpu.vrt.processor import VisionTextProcessor
from padt_tpu_torch import config as port_config
from padt_tpu_torch.convert.from_jax import params_from_numpy
from padt_tpu_torch.preprocess import vision_process as port_vision_process
from padt_tpu_torch.utils import mock_tokenizer as port_mock_tokenizer
from padt_tpu_torch.vrt import processor as port_processor

# float32 on both sides, every product at full precision
jax.config.update("jax_default_matmul_precision", "highest")

F32_TOL = 1e-5  # float32 on both sides; only the order of sums differs


@contextlib.contextmanager
def jax_mode(mode: str):
    """mode "xla": the JAX package's plain branches (PADT_PALLAS=0);
    "pallas": its Pallas kernels in TPU interpret mode."""
    old = os.environ.get("PADT_PALLAS")
    os.environ["PADT_PALLAS"] = "0" if mode == "xla" else "1"
    try:
        if mode == "pallas":
            from jax.experimental.pallas import tpu as pltpu

            with pltpu.force_tpu_interpret_mode():
                yield
        else:
            yield
    finally:
        if old is None:
            os.environ.pop("PADT_PALLAS", None)
        else:
            os.environ["PADT_PALLAS"] = old


def tiny_params(seed: int = 0):
    """(cfg, jax params, torch params): one f32 tree, bridged by key."""
    from padt_tpu.models import padt as P

    cfg = padt_tiny()
    jp = P.init_padt_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return cfg, jp, tp


def torch_cfg(cfg) -> port_config.PaDTConfig:
    """The port's config, field for field equal to a JAX config."""
    return port_config.PaDTConfig.from_json(cfg.to_json())


def tiny_processor(cfg):
    """The tiny processor of the package that `cfg` belongs to."""
    if isinstance(cfg, port_config.PaDTConfig):
        proc_cls, tok = port_processor.VisionTextProcessor, port_mock_tokenizer.make_tiny_tokenizer
    else:
        proc_cls, tok = VisionTextProcessor, make_tiny_tokenizer
    proc = proc_cls(tok(cfg), cfg, seq_bucket=32, patch_bucket=cfg.max_image_patches)
    proc.prepare(cfg.text.vocab_size)
    return proc


def seeded_image(grid_thw, seed: int, u8: bool) -> ProcessedImage:
    """A random image as patch rows: compact uint8 rows, or the f32 rows the
    host pipeline would produce from them."""
    t, h, w = grid_thw
    rows = np.random.RandomState(seed).randint(0, 256, (t * h * w, 3 * 14 * 14)).astype(np.uint8)
    if u8:
        return ProcessedImage(pixel_patches=None, grid_thw=grid_thw, pixel_patches_u8=rows)
    return ProcessedImage(pixel_patches=expand_u8_rows(rows), grid_thw=grid_thw)


def port_image(img: ProcessedImage) -> port_vision_process.ProcessedImage:
    """The same image as the port's `ProcessedImage`."""
    return port_vision_process.ProcessedImage(**{f.name: getattr(img, f.name) for f in dataclasses.fields(img)})


def jax_batch(data):
    return {k: jnp.asarray(v, jnp.bfloat16) if k == "pixel_patches" else jnp.asarray(v) for k, v in data.items()}


def torch_batch(data):
    return {
        k: torch.as_tensor(np.asarray(v)).to(torch.bfloat16) if k == "pixel_patches" else torch.as_tensor(np.asarray(v))
        for k, v in data.items()
    }


def close(a, b, tol=F32_TOL, rows=None):
    """max |a - b| <= tol * (1 + max |b|) on the selected rows."""
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b, np.float64)
    if rows is not None:
        a, b = a[rows], b[rows]
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= tol * (1.0 + np.abs(b).max()), (err, np.abs(b).max())
