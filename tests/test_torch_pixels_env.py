"""`PADT_COMPACT_PIXELS` chooses the pixel wire format of the port's
`InferenceEngine` as it does the JAX engine's: "0" gives float32 rows, "1"
(the default) compact uint8 rows. The port keeps the choice on the engine
and leaves its (shared) processor as it was; the JAX engine writes it into
its processor's `u8_pixels`."""

import numpy as np
import pytest
import torch

from test_torch_common import tiny_processor, torch_cfg
from padt_tpu.config import padt_tiny
from padt_tpu.eval.harness import InferenceEngine as JaxEngine
from padt_tpu.preprocess.vision_process import process_image as jax_process_image
from padt_tpu_torch.eval.harness import InferenceEngine as PortEngine


@pytest.mark.parametrize("env,compact", [("0", True), ("1", True), ("1", False)])
def test_compact_pixels_env_matches_jax(monkeypatch, env, compact):
    monkeypatch.setenv("PADT_COMPACT_PIXELS", env)
    cfg = padt_tiny()
    tcfg = torch_cfg(cfg)
    jproc, tproc = tiny_processor(cfg), tiny_processor(tcfg)
    before = dict(vars(tproc))
    jeng = JaxEngine({}, cfg, jproc, compact_pixels=compact)
    teng = PortEngine({"text": {"embed": torch.zeros(1)}}, tcfg, tproc, compact_pixels=compact)

    want = compact and env == "1"
    assert jeng.compact_pixels == teng.compact_pixels == want
    assert jproc.u8_pixels == want  # the JAX engine sets its processor's format
    assert vars(tproc) == before  # the port's processor is left as it was

    img = np.random.RandomState(7).randint(0, 256, (61, 93, 3)).astype(np.uint8)
    ref = jax_process_image(img, jproc.min_pixels, jproc.max_pixels, u8_rows=jproc.u8_pixels)
    (got,) = teng._processed([img])
    assert got.grid_thw == ref.grid_thw
    if want:
        assert got.pixel_patches is None and ref.pixel_patches is None
        assert got.pixel_patches_u8.dtype == np.uint8
        np.testing.assert_array_equal(got.pixel_patches_u8, ref.pixel_patches_u8)
    else:
        assert got.pixel_patches_u8 is None and ref.pixel_patches_u8 is None
        assert got.pixel_patches.dtype == np.float32
        np.testing.assert_array_equal(got.pixel_patches, ref.pixel_patches)
