"""Build and load the host-side native libraries of the data pipeline.

`native/flowpack.cpp` (the flowpack shard reader) and `native/jpegroi.cpp`
(the ROI JPEG decoder) are the JAX package's C++ sources; the port reads
them and writes nothing under `native/`. Each is compiled with `g++` at its
first use into `build/pixflow_tpu_torch/native/<hash>/` at the root of the
checkout, keyed by a hash of the source and the flags, and loaded with
`ctypes`, as `ops/kernels/build.py` does for the CUDA kernels. The flags
name no host CPU (`-march=native` is left out), so a library built on one
machine runs on another that shares the checkout."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_REPO = Path(__file__).resolve().parents[2]
NATIVE_DIR = _REPO / "native"
BUILD_DIR = _REPO / "build" / "pixflow_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")


@functools.cache
def load_native(name: str, libs: tuple[str, ...] = ()) -> ctypes.CDLL:
    """`native/<name>.cpp` as a loaded shared library, built first if its
    source or flags changed. `libs` are extra link flags (`-ljpeg`)."""
    src = NATIVE_DIR / f"{name}.cpp"
    flags = (*CXX_FLAGS, *libs)
    digest = hashlib.sha256(" ".join(flags).encode() + src.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / digest / f"lib{name}.so"
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
            out = Path(tmp) / so.name
            cmd = ["g++", *CXX_FLAGS, "-o", str(out), str(src), *libs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building {src.name} failed:\n$ {' '.join(cmd)}\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(out, so)  # atomic: concurrent builds race harmlessly
    return ctypes.CDLL(str(so))
