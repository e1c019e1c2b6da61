"""PaDT on PyTorch + CUDA for one NVIDIA H100: the port of `padt_tpu`.

`padt_tpu` (JAX on TPU) stays the reference; this package mirrors its
layout (`ops/`, `models/`, `eval/`, `serve/`, `train/`, `convert/`) and
function names, keeps its own copies of the reference's framework-neutral
host modules (`config`, `vrt/` processor and parser,
`preprocess/vision_process`, `models/vision_geom`, `models/mrope_index`,
`utils/mock_tokenizer`, `eval/rle`, `train/data`, `train/prefetch`), and
replaces its Pallas kernels with hand-written Hopper kernels under `csrc/`.

Importing this package imports neither jax nor anything of `padt_tpu`.
"""

import torch

# float32 products and convolutions run in full float32, never TF32: the
# CPU parity tests compare float32 paths at 1e-5, and a TF32 product keeps
# about three decimal digits. matmul's default is already False; cuDNN's is
# True, so both are set explicitly.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import PaDTConfig, padt_3b, padt_7b, padt_tiny  # noqa: E402

__all__ = ["PaDTConfig", "padt_3b", "padt_7b", "padt_tiny"]
