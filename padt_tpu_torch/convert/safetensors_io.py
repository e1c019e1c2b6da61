"""The safetensors file format in numpy, so that the port reads and writes
HF checkpoints without the `safetensors` package (or `ml_dtypes` for bf16).

A file is an 8-byte little-endian header length N, N bytes of JSON header
(padded with spaces to an 8-byte boundary), then the raw little-endian
tensor bytes. The header maps each tensor name to its `dtype` tag, `shape`
and `data_offsets` [begin, end) into the byte buffer, plus an optional
`__metadata__` dict of strings. A sharded checkpoint directory has
`model.safetensors.index.json`, whose `weight_map` names each tensor's file.

bf16 has no numpy dtype, so a BF16 tensor reads as its `uint16` bit
pattern, and a `uint16` array writes as BF16 (the format's U16 tag is not
supported, so the two cannot be confused); `to_torch` turns such a payload
into a `torch.bfloat16` tensor without a copy. Reads are `np.memmap` views
of the files: nothing is read twice, and a tensor's bytes are read when
they are first used.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

# tag -> numpy dtype (little-endian); BF16 is carried as its uint16 bits
DTYPES = {
    "BF16": np.dtype("<u2"),
    "F16": np.dtype("<f2"),
    "F32": np.dtype("<f4"),
    "F64": np.dtype("<f8"),
    "I8": np.dtype("i1"),
    "U8": np.dtype("u1"),
    "I16": np.dtype("<i2"),
    "I32": np.dtype("<i4"),
    "I64": np.dtype("<i8"),
    "BOOL": np.dtype("?"),
}
_TAGS = {dt: tag for tag, dt in DTYPES.items()}
INDEX_NAME = "model.safetensors.index.json"


def _tag(a: np.ndarray) -> str:
    if a.dtype.name == "bfloat16":  # an ml_dtypes array from another package
        return "BF16"
    tag = _TAGS.get(a.dtype.newbyteorder("<") if a.dtype.byteorder == ">" else a.dtype)
    if tag is None:
        raise TypeError(f"no safetensors dtype for numpy {a.dtype}")
    return tag


def _payload(a: np.ndarray) -> np.ndarray:
    """C-ordered little-endian bytes of `a` in the dtype its tag names."""
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    return np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("<") if a.dtype.byteorder == ">" else a.dtype)


def save_file(tensors: Mapping[str, np.ndarray], path: str, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (name -> numpy array; `uint16` = bf16 bits) to one
    safetensors file, in name order."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    arrays = {}
    offset = 0
    for name in sorted(tensors):
        a = np.asarray(tensors[name])
        tag = _tag(a)
        arrays[name] = _payload(a)
        n = arrays[name].nbytes
        header[name] = {"dtype": tag, "shape": list(a.shape), "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name in sorted(arrays):
            f.write(memoryview(arrays[name].reshape(-1).view(np.uint8)))


def read_header(path: str):
    """(header dict without `__metadata__`, metadata dict, byte offset of the data)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n).decode("utf-8"))
    meta = header.pop("__metadata__", None) or {}
    return header, meta, 8 + n


def load_file(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of one safetensors file, as read-only memmap views."""
    header, _, start = read_header(path)
    size = os.path.getsize(path) - start
    buf = np.memmap(path, dtype=np.uint8, mode="r", offset=start, shape=(size,)) if size else np.zeros(0, np.uint8)
    out = {}
    for name, info in header.items():
        dt = DTYPES.get(info["dtype"])
        if dt is None:
            raise TypeError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        b, e = info["data_offsets"]
        shape = tuple(info["shape"])
        if e - b != int(np.prod(shape, dtype=np.int64)) * dt.itemsize or e > size:
            raise ValueError(f"{path}: tensor {name} has {e - b} bytes for shape {shape} {info['dtype']}")
        out[name] = buf[b:e].view(dt).reshape(shape)
    return out


def load_dir(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a checkpoint directory: the files its
    `model.safetensors.index.json` names, or else every `*.safetensors`."""
    index = os.path.join(path, INDEX_NAME)
    if os.path.exists(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors files in {path}")
    out: Dict[str, np.ndarray] = {}
    for name in files:
        out.update(load_file(os.path.join(path, name)))
    return out


def to_torch(a: np.ndarray, device="cpu", dtype=None):
    """A numpy array of this module's convention -> a torch tensor on
    `device` (`uint16` becomes bfloat16 by its bits); floating tensors are
    cast to `dtype` when it is given."""
    if not (a.flags.c_contiguous and a.flags.writeable):  # e.g. a memmap view of a file
        a = np.array(a, order="C")
    t = torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)
    if a.dtype == np.uint16:
        t = t.view(torch.bfloat16)
    t = t.to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def from_torch(t) -> np.ndarray:
    """A torch tensor -> a numpy array of this module's convention (one
    device-to-host copy; bf16 stays bf16, as its `uint16` bits)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()
