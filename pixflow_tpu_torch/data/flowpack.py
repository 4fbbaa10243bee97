"""Python bindings + writer for flowpack shards (native reader in
`native/flowpack.cpp`; see its header for the on-disk layout).

The writer packs a directory of per-video flow files (.pth / .npy) — or
in-memory arrays — into one shard; the ctypes reader serves exact flow-window
slices from the mmap with no deserialization. The port's own copy of
`pixflow_tpu/data/flowpack.py`: the shared library is built on demand
with g++ from the JAX package's `native/flowpack.cpp` into the port's
build directory (`data/native.py`); `native/` itself is never written."""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Iterable, Tuple

import numpy as np

from .native import load_native

_MAGIC = b"FLOWPAK1"
_NAME_LEN = 64
_LIB = None


def _load_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = load_native("flowpack")
    lib.fp_open.restype = ctypes.c_void_p
    lib.fp_open.argtypes = [ctypes.c_char_p]
    lib.fp_close.argtypes = [ctypes.c_void_p]
    lib.fp_num_videos.restype = ctypes.c_int32
    lib.fp_num_videos.argtypes = [ctypes.c_void_p]
    lib.fp_meta.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
                            ctypes.POINTER(ctypes.c_uint32),
                            ctypes.POINTER(ctypes.c_uint32)]
    lib.fp_find.restype = ctypes.c_int32
    lib.fp_find.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.fp_video_num_flows.restype = ctypes.c_int32
    lib.fp_video_num_flows.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.fp_read.restype = ctypes.c_int64
    lib.fp_read.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                            ctypes.c_int32, ctypes.c_void_p]
    _LIB = lib
    return lib


def write_flowpack(path: str, videos: Iterable[Tuple[str, np.ndarray]],
                   dtype: str = "float16") -> None:
    """videos: iterable of (name, flows [num_flows, h, w, 2]). Names are
    sorted for the reader's binary search; flows stored f16 by default
    (halves the corpus; flow magnitudes < 1k px lose <0.1% precision)."""
    items = sorted(videos, key=lambda kv: kv[0])
    assert items, "empty pack"
    h, w = items[0][1].shape[1:3]
    np_dtype = np.float16 if dtype == "float16" else np.float32
    dtype_code = 1 if dtype == "float16" else 0

    entry_fmt = f"{_NAME_LEN}sQII"
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<IIIIII", len(items), h, w, dtype_code,
                            _NAME_LEN, 0))
        offset = 0
        for name, flows in items:
            assert len(name.encode()) < _NAME_LEN, f"name too long: {name}"
            assert flows.shape[1:] == (h, w, 2), \
                f"{name}: inconsistent flow shape {flows.shape}"
            f.write(struct.pack("<" + entry_fmt, name.encode(), offset,
                                flows.shape[0], 0))
            offset += flows.shape[0] * h * w * 2 * np_dtype().itemsize
        for _, flows in items:
            f.write(np.ascontiguousarray(flows, np_dtype).tobytes())


def pack_flow_dir(flow_dir: str, out_path: str, dtype: str = "float16",
                  n_shards: int = 1):
    """Pack a directory of per-video .pth/.npy flow files.

    n_shards == 1: one `.fpk` file at out_path. n_shards > 1: out_path is a
    directory receiving `shard-%05d-of-%05d.fpk` with videos striped
    round-robin over sorted names — per-host corpora for multi-host
    training (each host's loader touches only its own videos' pages, and
    shards can live on different filesystems)."""
    from .datasets import load_flow_file

    names = [os.path.splitext(f) for f in sorted(os.listdir(flow_dir))]
    names = [(stem, ext) for stem, ext in names if ext in (".pth", ".npy")]

    def gen(subset):
        for stem, ext in subset:
            flows, _ = load_flow_file(os.path.join(flow_dir, stem + ext),
                                      0, 10**9)
            yield stem, flows

    if n_shards <= 1:
        write_flowpack(out_path, gen(names), dtype)
        return
    os.makedirs(out_path, exist_ok=True)
    for s in range(n_shards):
        write_flowpack(
            os.path.join(out_path, f"shard-{s:05d}-of-{n_shards:05d}.fpk"),
            gen(names[s::n_shards]), dtype)


class FlowPackReader:
    """Zero-deserialization flow-window reader over an mmap'd shard."""

    def __init__(self, path: str):
        self._lib = _load_lib()
        self._h = self._lib.fp_open(path.encode())
        if not self._h:
            raise FileNotFoundError(f"cannot open flowpack {path}")
        hh = ctypes.c_uint32()
        ww = ctypes.c_uint32()
        dt = ctypes.c_uint32()
        self._lib.fp_meta(self._h, ctypes.byref(hh), ctypes.byref(ww),
                          ctypes.byref(dt))
        self.h, self.w = hh.value, ww.value
        self.dtype = np.float16 if dt.value == 1 else np.float32

    def __len__(self):
        return self._lib.fp_num_videos(self._h)

    def find(self, name: str) -> int:
        return self._lib.fp_find(self._h, name.encode())

    def num_flows(self, idx: int) -> int:
        return self._lib.fp_video_num_flows(self._h, idx)

    def read(self, name_or_idx, start: int, count: int) -> np.ndarray:
        idx = (self.find(name_or_idx) if isinstance(name_or_idx, str)
               else name_or_idx)
        if idx < 0:
            raise KeyError(f"video '{name_or_idx}' not in pack")
        # bound the window BEFORE allocating: np.empty sized from untrusted
        # header/count values must never outrun the (open-validated) video
        if count < 0 or start < 0 or start + count > self.num_flows(idx):
            raise IndexError(f"flow window {name_or_idx}[{start}:"
                             f"{start + count}] out of range")
        out = np.empty((count, self.h, self.w, 2), self.dtype)
        got = self._lib.fp_read(self._h, idx, start, count,
                                out.ctypes.data_as(ctypes.c_void_p))
        if got < 0:
            raise IndexError(f"fp_read failed ({got}) for "
                             f"{name_or_idx}[{start}:{start + count}]")
        # return the STORED dtype (f16 packs stay f16): the default
        # pipeline ships f16 to the device anyway, and an eager f32
        # upcast here forced an f32->f16 copy back in datasets.py (~10%
        # of the per-sample host budget)
        return out

    def close(self):
        if self._h:
            self._lib.fp_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class MultiPackReader:
    """Reader over a directory of flowpack shards (`pack_flow_dir`
    n_shards>1 layout). Same interface as FlowPackReader; `find` returns an
    opaque handle encoding (shard, index)."""

    _SHARD_SHIFT = 32

    def __init__(self, path: str):
        import glob as _glob
        paths = sorted(_glob.glob(os.path.join(path, "*.fpk")))
        if not paths:
            raise FileNotFoundError(f"no .fpk shards under {path}")
        self._readers = [FlowPackReader(p) for p in paths]
        self.h, self.w = self._readers[0].h, self._readers[0].w
        self.dtype = self._readers[0].dtype

    def __len__(self):
        return sum(len(r) for r in self._readers)

    def find(self, name: str) -> int:
        for si, r in enumerate(self._readers):
            i = r.find(name)
            if i >= 0:
                return (si << self._SHARD_SHIFT) | i
        return -1

    def num_flows(self, handle: int) -> int:
        if handle < 0:
            raise KeyError("invalid flowpack handle (video not in any shard)")
        r = self._readers[handle >> self._SHARD_SHIFT]
        return r.num_flows(handle & ((1 << self._SHARD_SHIFT) - 1))

    def read(self, name_or_handle, start: int, count: int) -> np.ndarray:
        if isinstance(name_or_handle, str):
            name_or_handle = self.find(name_or_handle)
        if name_or_handle < 0:
            raise KeyError("video not in any shard")
        r = self._readers[name_or_handle >> self._SHARD_SHIFT]
        return r.read(name_or_handle & ((1 << self._SHARD_SHIFT) - 1),
                      start, count)

    def close(self):
        for r in self._readers:
            r.close()


def open_flow_source(path: str):
    """FlowPackReader for a single `.fpk` file, MultiPackReader for a
    directory of shards."""
    if os.path.isdir(path):
        return MultiPackReader(path)
    return FlowPackReader(path)
