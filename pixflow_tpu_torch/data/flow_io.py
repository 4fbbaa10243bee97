"""Optical-flow file formats: Middlebury .flo, PFM and KITTI 16-bit PNG,
with `read_flow_auto` by extension. The port's own copy of
`pixflow_tpu/data/flow_io.py` (the reference's
`contrast/flow/utils/frame_utils.py` readers and writers), numpy and the
standard library only: KITTI's 16-bit RGB PNGs, which PIL reads as 8-bit,
go through a small PNG codec here (zlib, the five row filters)."""

from __future__ import annotations

import os
import re
import struct
import zlib

import numpy as np

_FLO_MAGIC = 202021.25
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo -> [H, W, 2] float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)[0]
        if magic != _FLO_MAGIC:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        data = np.fromfile(f, np.float32, 2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.asarray([_FLO_MAGIC], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        flow.tofile(f)


def read_pfm(path: str):
    """PFM -> (data [H, W] or [H, W, 3] float32, scale)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header not in (b"PF", b"Pf"):
            raise ValueError("not a PFM file")
        color = header == b"PF"
        m = re.match(r"^(\d+)\s(\d+)\s*$", f.readline().decode("ascii"))
        if not m:
            raise ValueError("malformed PFM header")
        w, h = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape)), abs(scale)


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    image = np.asarray(image, np.float32)
    color = image.ndim == 3 and image.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        np.flipud(image).tofile(f)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _write_png_rgb16(path: str, rgb: np.ndarray) -> None:
    """[H, W, 3] uint16 -> a 16-bit RGB PNG, every row unfiltered."""
    h, w, _ = rgb.shape
    rows = rgb.astype(">u2").view(np.uint8).reshape(h, w * 6)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The decoded scanlines [H, stride] uint8 of a non-interlaced PNG."""
    lines = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = lines[y, 0], lines[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: running sum of each byte lane of a pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:  # Up
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: each pixel needs its left one
            cur = np.zeros(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prev[x:x + bpp]
                pred = (left + up) // 2 if kind == 3 else _paeth(left, up, up_left)
                left = (line[x:x + bpp] + pred) & 0xFF
                cur[x:x + bpp] = left
                up_left = up
        else:
            raise ValueError(f"PNG row filter {kind}")
        out[y] = prev = cur
    return out.astype(np.uint8)


def _read_png_rgb16(path: str) -> np.ndarray:
    """A 16-bit RGB PNG -> [H, W, 3] uint16."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no PNG header")
    w, h, depth, color, _, _, interlace = header
    if depth != 16 or color != 2 or interlace != 0:
        raise ValueError(f"{path}: not a 16-bit RGB non-interlaced PNG "
                         f"(depth {depth}, colour type {color}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    lines = _unfilter(raw, h, w * 6, 6)
    return lines.reshape(h, w * 3, 2).copy().view(">u2").reshape(h, w, 3).astype(np.uint16)


def read_kitti_png(path: str):
    """KITTI 16-bit flow PNG -> (flow [H, W, 2] float32, valid [H, W] bool)."""
    arr = _read_png_rgb16(path).astype(np.float32)  # (u, v, valid)
    flow = (arr[..., :2] - 2 ** 15) / 64.0
    valid = arr[..., 2] > 0
    return flow, valid


def write_kitti_png(path: str, flow: np.ndarray, valid=None) -> None:
    h, w = flow.shape[:2]
    out = np.zeros((h, w, 3), np.uint16)
    out[..., :2] = (np.asarray(flow, np.float64) * 64.0 + 2 ** 15).astype(np.uint16)
    out[..., 2] = 1 if valid is None else np.asarray(valid, np.uint16)
    _write_png_rgb16(path, out)


def read_flow_auto(path: str) -> np.ndarray:
    """A flow [H, W, 2] from a .flo, .pfm, KITTI .png or .npy file."""
    ext = os.path.splitext(path)[-1].lower()
    if ext == ".flo":
        return read_flo(path)
    if ext == ".pfm":
        return read_pfm(path)[0][..., :2]
    if ext == ".png":
        return read_kitti_png(path)[0]
    if ext == ".npy":
        return np.load(path)
    raise NotImplementedError(ext)
