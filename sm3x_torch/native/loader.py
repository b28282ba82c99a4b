"""ctypes binding for the native decode / letterbox loader (`loader.cpp`,
the port's own copy of sm3x/native/loader.cpp).

The library is built with g++ against libjpeg at first use, into
`build/sm3x_torch/` at the root of the checkout, beside the CUDA kernels'
library, and rebuilt when the source is newer. Without a compiler or
libjpeg, `native_loader_available()` is False and `decode_letterbox_batch`
marks every file as not taken, so the caller decodes them with OpenCV."""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sm3x_torch"
_SO = BUILD_DIR / "libsm3x_loader.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # built under another name and moved into place: a process that
        # finds the library finds a whole one
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, str(_SRC),
               "-ljpeg", "-lpthread"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, _SO)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return True
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if (not _SO.exists()
                or _SO.stat().st_mtime < _SRC.stat().st_mtime):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_SO))
            lib.sm3x_decode_letterbox_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                ctypes.c_int,
            ]
            lib.sm3x_decode_letterbox_batch.restype = None
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def native_loader_available() -> bool:
    return _load() is not None


def decode_letterbox_batch(paths: Sequence[str], cache_size: int,
                           crop_amount: int, workers: int = 8
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode JPEGs into (canvases (N, S, S, 3) u8, valid_hw (N, 2) i32,
    ok (N,) bool). Entries that are no JPEG or cannot be read come back
    ok=False: the caller decodes those through the Python path."""
    lib = _load()
    n = len(paths)
    canvases = np.zeros((n, cache_size, cache_size, 3), np.uint8)
    hw = np.zeros((n, 2), np.int32)
    ok = np.zeros((n,), np.int32)
    if lib is None or n == 0:
        return canvases, hw, ok.astype(bool)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.sm3x_decode_letterbox_batch(
        arr, n, cache_size, crop_amount, canvases, hw.reshape(-1), ok, workers)
    return canvases, hw, ok.astype(bool)
