"""Build and load the port's CUDA kernels.

Every source under `pixflow_tpu_torch/csrc/` is compiled by `nvcc` for
`sm_90a` (one process per source, all started together), linked into one
shared library with a plain C interface, and loaded with `ctypes`. Nothing
includes PyTorch's headers, so a build takes seconds. The library goes to
`build/pixflow_tpu_torch/<hash>/` at the root of the checkout, keyed by a
hash of the sources, their headers (`*.cuh`) and the flags: an edited
source is rebuilt at its first use.
Building happens at the first kernel launch, never at import."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "pixflow_tpu_torch"
LIB_NAME = "libpixflow_kernels.so"

# --fmad=false: the kernels reproduce float32 op orders that the plain
# versions (and the JAX package) evaluate without contraction into FMAs.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit (nvcc) was not found; the port's "
                           "kernels are built from pixflow_tpu_torch/csrc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for c in cmds]
    failures = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out.decode(errors='replace')}")
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))


def _build(out_dir: Path, sources: list[Path]) -> None:
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                  for src, obj in zip(sources, objs)])
        lib_tmp = Path(tmp) / LIB_NAME
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                   "-o", str(lib_tmp)]])
        os.replace(lib_tmp, out_dir / LIB_NAME)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if its sources changed."""
    sources = _sources()
    lib_path = BUILD_DIR / _digest(sources) / LIB_NAME
    if not lib_path.exists():
        _build(lib_path.parent, sources)
    return ctypes.CDLL(str(lib_path))


def c_function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry of the library with its signature declared; every entry
    returns the `cudaError_t` of its launch as an int."""
    fn = getattr(load_library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
