"""`cv2.resize(src, dsize)` of a 2-D uint8 array (INTER_LINEAR, the
default) in numpy, so the scorers and the dataset preprocessing need no
OpenCV.

OpenCV resizes uint8 images in fixed point, not through float32: each
axis's two weights are 1 - f and f rounded to 11-bit integers
(INTER_RESIZE_COEF_BITS, 2048 = 1.0); the horizontal pass sums
`src * weight` in int32, and the vertical pass is its vector kernel's
integer form, `((((r0 >> 4) * b0) >> 16) + (((r1 >> 4) * b1) >> 16) + 2) >> 2`.
Source positions are f = (d + 0.5) * (1 / (n_dst / n_src)) - 0.5 in float32
(OpenCV's expression): columns past an edge take the edge pixel with f = 0,
rows past an edge keep their fraction and read the edge row twice. An
exact 2x downscale on both axes is OpenCV's area path, (sum of the 2x2
block + 2) >> 2, which this arithmetic also gives. The result differs from
a float32 bilinear resize: on a 0/1 mask, a 1 whose weight is below one
half rounds to 0 here.
"""

from __future__ import annotations

import numpy as np

_ONE = 2048  # 1 << INTER_RESIZE_COEF_BITS


def _taps(n_src: int, n_dst: int, clamp: bool):
    """Each destination index's two source indices and 11-bit weights."""
    f = ((np.arange(n_dst, dtype=np.float64) + 0.5) * (1.0 / (n_dst / n_src)) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        edge = (s < 0) | (s >= n_src - 1)
        f[edge] = 0.0
        s = np.where(s < 0, 0, np.where(s >= n_src - 1, n_src - 1, s))
    w1 = np.rint(f * np.float32(_ONE)).astype(np.int64)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_ONE)).astype(np.int64)
    return np.clip(s, 0, n_src - 1), np.clip(s + 1, 0, n_src - 1), w0, w1


def resize_linear_u8(src: np.ndarray, dsize) -> np.ndarray:
    """`cv2.resize(src, dsize)` of a 2-D uint8 array; dsize = (width, height)."""
    src = np.asarray(src)
    if src.dtype != np.uint8 or src.ndim != 2:
        raise ValueError(f"expected a 2-D uint8 array, got {src.dtype} {src.shape}")
    (h, w), (dw, dh) = src.shape, dsize
    x0, x1, a0, a1 = _taps(w, dw, clamp=True)
    y0, y1, b0, b1 = _taps(h, dh, clamp=False)
    s = src.astype(np.int64)
    rows = s[:, x0] * a0 + s[:, x1] * a1  # (h, dw), weights summing to 2048
    v = ((rows[y0] >> 4) * b0[:, None] >> 16) + ((rows[y1] >> 4) * b1[:, None] >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)
