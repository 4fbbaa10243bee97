"""ctypes bindings for the native ROI JPEG decoder (native/jpegroi.cpp).

`JpegSource` is a lazy stand-in for a decoded PIL image in the crop
pipeline: it reads only the JPEG header for `.size` (crop boxes are sampled
from dimensions, not pixels) and then decodes JUST the sampled crop band —
DCT-domain downscaled when the crop is much larger than the target — fused
with the same scale-adaptive triangle resize PIL's `Image.resize(BILINEAR)`
performs. The reference pipeline (DataLoader + PIL,
`contrast/data/dataset.py`) decodes every full frame first; this is the
DALI-style decode path reshaped for the two-crop protocol.

The port's own copy of `pixflow_tpu/data/jpegroi.py`: the library is built
on demand with g++ and `-ljpeg` from the JAX package's `native/jpegroi.cpp`
into the port's build directory (`data/native.py`); `native/` itself is
never written. Only `--native-decode` reaches it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from .native import load_native

_LIB = None


def load_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = load_native("jpegroi", ("-ljpeg",))
    lib.jr_header.restype = ctypes.c_int
    lib.jr_header.argtypes = [ctypes.c_char_p, ctypes.c_long,
                              ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_int)]
    lib.jr_decode_crop_resize.restype = ctypes.c_int
    lib.jr_decode_crop_resize.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.jr_transcode_restart.restype = ctypes.c_int
    lib.jr_transcode_restart.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
    lib.jr_restart_rows.restype = ctypes.c_int
    lib.jr_restart_rows.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.jr_splice_used.restype = ctypes.c_int
    lib.jr_splice_used.argtypes = []
    _LIB = lib
    return lib


def transcode_restart(data: bytes, rows: int = 1) -> bytes:
    """Losslessly re-wrap a JPEG's DCT coefficients with a restart marker
    every `rows` MCU rows (jpegtran-style; identical pixels). Run once at
    data-prep time (tools/transcode_restart.py): the crop decoder then
    splices out just the needed MCU rows instead of entropy-decoding every
    row above the crop band."""
    lib = load_lib()
    cap = len(data) + len(data) // 2 + (1 << 16)
    out = ctypes.create_string_buffer(cap)
    n = ctypes.c_long()
    rc = lib.jr_transcode_restart(data, len(data), rows, out, cap,
                                  ctypes.byref(n))
    if rc == 5:  # grew past the guess: retry at the reported size
        cap = n.value
        out = ctypes.create_string_buffer(cap)
        rc = lib.jr_transcode_restart(data, len(data), rows, out, cap,
                                      ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"jpeg restart transcode failed (rc={rc})")
    return out.raw[:n.value]


def restart_rows(data: bytes) -> int:
    """MCU rows per restart interval if the stream is splice-compatible
    (baseline, restart-row-aligned DRI); 0 otherwise."""
    return load_lib().jr_restart_rows(data, len(data))


def splice_used() -> bool:
    """Whether the last decode_crop_resize on this thread took the
    restart-splice fast path (telemetry for tests/benches)."""
    return bool(load_lib().jr_splice_used())


def jpeg_size(data: bytes) -> Tuple[int, int]:
    """(width, height) from the JPEG header (no pixel decode)."""
    lib = load_lib()
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.jr_header(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise ValueError("not a decodable JPEG")
    return w.value, h.value


def decode_crop_resize(data: bytes, box: Tuple[int, int, int, int],
                       out_size: Tuple[int, int],
                       max_denom: int = 8) -> np.ndarray:
    """Decode crop `box` = (x, y, w, h) resized to `out_size` = (W, H).
    Returns [H, W, 3] uint8. max_denom bounds the DCT-domain downscale
    (1 = full-fidelity band decode)."""
    lib = load_lib()
    x, y, w, h = box
    out_w, out_h = out_size
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.jr_decode_crop_resize(
        data, len(data), int(x), int(y), int(w), int(h), int(out_w),
        int(out_h), int(max_denom), out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"jpegroi decode failed (rc={rc})")
    return out


class JpegSource:
    """Lazy JPEG crop source with the subset of the PIL Image surface the
    crop transform needs (`.size` + `crop_resize`)."""

    __slots__ = ("data", "_size", "max_denom")

    def __init__(self, data: bytes, max_denom: int = 8):
        self.data = data
        self.max_denom = max_denom
        self._size: Optional[Tuple[int, int]] = None

    @property
    def size(self) -> Tuple[int, int]:
        if self._size is None:
            self._size = jpeg_size(self.data)
        return self._size

    def crop_resize(self, box, out_size) -> np.ndarray:
        return decode_crop_resize(self.data, box, out_size, self.max_denom)

    def to_pil(self):
        """Full decode fallback (non-crop consumers)."""
        import io

        from PIL import Image
        return Image.open(io.BytesIO(self.data)).convert("RGB")
