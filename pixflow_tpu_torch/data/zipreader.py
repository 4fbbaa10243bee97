"""Zip-archive member access with the `archive.zip@/inner/path` convention
and per-process handle caching (capability of reference
`contrast/data/zipreader.py`). The port's own copy of
`pixflow_tpu/data/zipreader.py`, unchanged."""

from __future__ import annotations

import os
import threading
import zipfile

_SEP = "@"
_handles: dict = {}
_locks: dict = {}
_registry_lock = threading.Lock()


def is_zip_path(path: str) -> bool:
    return ".zip" + _SEP in path


def split_zip_path(path: str):
    pos = path.index(".zip" + _SEP)
    archive = path[: pos + 4]
    inner = path[pos + 5:]
    return archive, inner.lstrip("/")


def _handle(archive: str):
    """Cached (ZipFile, lock) per archive+pid. ZipFile reads seek a shared
    file object, so concurrent loader threads must serialize on the lock."""
    key = (archive, os.getpid())
    with _registry_lock:
        zf = _handles.get(key)
        if zf is None:
            zf = zipfile.ZipFile(archive, "r")
            _handles[key] = zf
            _locks[key] = threading.Lock()
        return zf, _locks[key]


def read_bytes(path: str) -> bytes:
    archive, inner = split_zip_path(path)
    zf, lock = _handle(archive)
    with lock:
        return zf.read(inner)


def list_members(archive: str, suffix: str = ""):
    zf, lock = _handle(archive)
    with lock:
        return [n for n in zf.namelist() if n.endswith(suffix)]
