"""Build and load the port's CUDA kernels (`sm3x_torch/csrc/*.cu`).

The kernels are compiled with `nvcc` into one shared library with plain
`extern "C"` entry points and loaded with `ctypes`: no PyTorch headers, so
a build takes seconds. The library lands in `build/sm3x_torch/` at the
root of the checkout and is rebuilt when the sources or flags change (a
hash of both is kept beside it). Nothing here runs at import time; the
first kernel launch builds. A missing `nvcc` or a failed build raises.

Each entry point returns `cudaGetLastError()` after its launches;
`check()` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sm3x_torch"
LIB_NAME = "libsm3x_kernels.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Shared memory one block can use on an H100 (227 KB), static and dynamic
# together; the wrappers' shape plans size their tiles under it.
SHARED_MEMORY_BYTES = 232448

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # images, params, out, B, H, W, cluster, band, px, threads, mean x3,
    # std x3, stream
    "sm3x_photometric_band": [_c_void_p] * 3 + [_c_int] * 7 + [_c_float] * 6
    + [_c_void_p],
    # images, params, scratch, out, B, H, W, mean x3, std x3, stream
    "sm3x_photometric_scratch": [_c_void_p] * 4 + [_c_int] * 3
    + [_c_float] * 6 + [_c_void_p],
    # z, loss, lse, inv, P, n, D, tile_rows, cw, vec, temperature, stream
    "sm3x_ntxent_fwd": [_c_void_p] * 4 + [_c_int] * 6 + [_c_float, _c_void_p],
    # z, lse, inv, g, dz, P, n, D, tile_rows, cw, warps, blocks, vec,
    # temperature, stream
    "sm3x_ntxent_bwd": [_c_void_p] * 5 + [_c_int] * 8 + [_c_float, _c_void_p],
    # ptrs (host array), strides (host int64 array), B, S, H, D, scale,
    # bf16, stream
    "sm3x_flash_fwd": [_c_void_p] * 2 + [_c_int] * 4 + [_c_float, _c_int,
                                                        _c_void_p],
    "sm3x_flash_bwd_dq": [_c_void_p] * 2 + [_c_int] * 4 + [_c_float, _c_int,
                                                           _c_void_p],
    "sm3x_flash_bwd_dkv": [_c_void_p] * 2 + [_c_int] * 4 + [_c_float, _c_int,
                                                            _c_void_p],
    # src, dst, n, stream
    "sm3x_copy": [_c_void_p, _c_void_p, ctypes.c_longlong, _c_void_p],
    # x, slot_assign, out, S, k, pieces, stream
    "sm3x_moe_dispatch_fwd": [_c_void_p] * 3 + [_c_int] * 3 + [_c_void_p],
    # y, gates, token_slot, out, N, k, pieces, bf16, stream
    "sm3x_moe_combine_fwd": [_c_void_p] * 4 + [_c_int] * 4 + [_c_void_p],
    # dout, y, gates, slot_assign, dy, dgates, S, k, pieces, bf16, stream
    "sm3x_moe_combine_bwd": [_c_void_p] * 6 + [_c_int] * 4 + [_c_void_p],
    # dslots, token_slot, dx, N, k, pieces, bf16, stream
    "sm3x_moe_dispatch_bwd": [_c_void_p] * 3 + [_c_int] * 4 + [_c_void_p],
    # x, residual, y, mean, invstd, gamma, beta, running_mean, running_var,
    # steps, part, rows, chunks, tc_log2, columns, blocks, bf16, relu,
    # momentum, eps, stream
    "sm3x_bn_fwd": [_c_void_p] * 11 + [_c_int] * 7 + [_c_float] * 2
    + [_c_void_p],
    # dy, x, y, mean, invstd, gamma, beta, sums, dgamma, dbeta, dx, dres,
    # part, rows, chunks, tc_log2, columns, blocks, bf16, mask, stream
    "sm3x_bn_bwd": [_c_void_p] * 13 + [_c_int] * 7 + [_c_void_p],
}

_lock = threading.Lock()
_lib = None
build_log = ""        # nvcc's output of the last build (ptxas register use)
build_seconds = 0.0   # 0.0 when the library was loaded without a build


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and PATH): the port's CUDA "
        "kernels are built from sm3x_torch/csrc at first use")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(repr(NVCC_FLAGS).encode())
    return h.hexdigest()


def _build(digest: str) -> None:
    global build_log, build_seconds
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(obj)
        for cmd, proc in procs:
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")
        lib_tmp = os.path.join(tmp, LIB_NAME)
        link = [nvcc, "-shared", "-o", lib_tmp, *objs]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(lib_tmp, BUILD_DIR / LIB_NAME)
    (BUILD_DIR / "sources.sha256").write_text(digest)
    build_log = "".join(log)
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            digest = _digest()
            stamp = BUILD_DIR / "sources.sha256"
            if (not (BUILD_DIR / LIB_NAME).exists() or not stamp.exists()
                    or stamp.read_text() != digest):
                _build(digest)
            lib = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def stream_handle(device) -> int:
    """The current CUDA stream of `device` as an integer handle. The raw
    getter, where this torch has it, skips building a Stream object (8 us
    a call on the host of an H100 machine, every launch pays it)."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None and device.index is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream
