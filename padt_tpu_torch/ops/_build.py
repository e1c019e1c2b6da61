"""Build and load the port's CUDA kernels.

Each of `padt_tpu_torch/csrc/*.cu` compiles, with its own `nvcc` for
`sm_90a` (all started together), into an object; one link makes a shared
library with a plain C interface, loaded with `ctypes`. The library lands in
`build/padt_tpu_torch/` at the repository root, named by a hash of the
sources and flags, so an edited source is rebuilt at its first use and an
unchanged one is loaded as it is. Nothing is built when the module is
imported: the first kernel launch builds. ptxas's report of every kernel's
registers and spills is kept beside the library (`resource_usage`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "padt_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # name: argtypes (every pointer and the stream as c_void_p)
    "padt_rope_qk": [_P, _LL, _P, _LL, _P, _P, _P, _P] + [_I] * 8 + [_F, _P],
    "padt_segment_flash_fwd": [_P] * 7 + [_I] * 6 + [_LL] * 9 + [_I, _F, _P],
    "padt_flash_bwd_dq": [_P] * 9 + [_I] * 6 + [_LL] * 12 + [_I, _F, _P],
    "padt_flash_bwd_dkv": [_P] * 10 + [_I] * 6 + [_LL] * 12 + [_I, _F, _P],
    "padt_window_slot_attn": [_P, _P, _P, _P, _P, _I, _I, _I, _I] + [_LL] * 9 + [_F, _I, _I, _I, _P],
    "padt_int8_decode_attn": [_P] * 12 + [_I] * 9 + [_F, _P],
    "padt_int8_verify_attn": [_P] * 12 + [_I] * 10 + [_F, _P],
    "padt_store_kv_rows": [_P] * 10 + [_I] * 9 + [_P],
    "padt_int8_matmul": [_P, _LL, _P, _P, _P] + [_I] * 7 + [_P],
    "padt_stream_matmul": [_P, _LL] + [_P] * 5 + [_I] * 5 + [_F] + [_I] * 4 + [_P],
    "padt_expert_matmul": [_P] * 6 + [_I] * 9 + [_P],
    "padt_swiglu": [_P, _P, _LL, _I, _P],
}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on a machine with the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libpadt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources into the library unless it already exists."""
    so = library_path()
    if so.exists():
        return so
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(cu, objs)]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for cmd in cmds]
    failed, report = [], []
    for cmd, pr in procs:  # wait for every compile before reporting any
        out, _ = pr.communicate()
        report.append(out)
        if pr.returncode != 0:
            failed.append(f"nvcc failed ({pr.returncode}):\n{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    so.with_suffix(".ptxas.txt").write_text("".join(report))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    for obj in objs:
        obj.unlink()
    return so


def resource_usage() -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from ptxas's report of the current library's build (built
    first if needed)."""
    text = build().with_suffix(".ptxas.txt").read_text()
    usage, name, spills = {}, None, (0, 0)
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name, spills = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name is not None:
            usage[name] = (int(m.group(1)), *spills)
            name = None
    return usage


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, with every entry
    point's argument types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.padt_error_string.argtypes = [ctypes.c_int]
    lib.padt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.padt_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
