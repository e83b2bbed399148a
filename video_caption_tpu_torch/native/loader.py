"""ctypes bridge to the C++ frame loader (frame_loader.cpp).

Build-on-first-use: compiles the shared library with g++ into
``build/native`` at the root of the checkout (git-ignored;
``VIDEO_CAPTION_TORCH_NATIVE_CACHE`` moves it), keyed by a source hash, and
loads it with ctypes (no pybind11
dependency). The build is atomic: g++ writes ``<stem>.<pid>.tmp.so`` and
``os.replace`` moves it to the library's name, so processes that build into
one cache at once each load a whole library (never one another g++ is still
writing), and a failed build leaves no file behind. Any failure — missing toolchain, missing libjpeg, decode error
— returns None and the caller uses the PIL path, mirroring the reference's
CuPy fallback contract (cupy_vit_pool.py:185-186).
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

_SRC = Path(__file__).with_name("frame_loader.cpp")
_LIB = None
_LIB_FAILED = False

last_backend: Optional[str] = None
last_error: Optional[str] = None

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _build_library() -> Optional[ctypes.CDLL]:
    import platform

    source = _SRC.read_text()
    # key = source + flags + machine: -march=native output is CPU-specific, so
    # a cache dir shared across heterogeneous hosts (NFS) must not serve a
    # library built for another machine's ISA (SIGILL), and flag changes must
    # invalidate the cache
    cmd_flags = "-O3 -march=native -funroll-loops"
    cpu_id = platform.machine()
    try:  # -march=native differs per CPU model; key on the host CPU identity
        for line in open("/proc/cpuinfo"):
            if line.startswith(("model name", "flags")):
                cpu_id += line
                break
    except OSError:
        pass
    digest = hashlib.sha256((source + cmd_flags + cpu_id).encode()).hexdigest()[:16]
    cache = Path(os.environ.get(
        "VIDEO_CAPTION_TORCH_NATIVE_CACHE",
        Path(__file__).resolve().parents[2] / "build" / "native",
    ))
    cache.mkdir(parents=True, exist_ok=True)
    lib_path = cache / f"libvct_loader_{digest}.so"
    if not lib_path.exists():
        tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
        cmd = [
            "g++", *cmd_flags.split(),
            "-std=c++17", "-shared", "-fPIC", str(_SRC),
            "-o", str(tmp), "-ljpeg", "-pthread",
        ]
        log.info("building native frame loader: %s", " ".join(cmd))
        result = subprocess.run(cmd, capture_output=True, text=True)
        if result.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native build failed: {result.stderr[-500:]}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.vct_load_frames.restype = ctypes.c_int
    lib.vct_load_frames.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.vct_load_frames_u8.restype = ctypes.c_int
    lib.vct_load_frames_u8.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
    ]
    lib.vct_load_frames_yuv420.restype = ctypes.c_int
    lib.vct_load_frames_yuv420.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED, last_error
    if _LIB is None and not _LIB_FAILED:
        try:
            _LIB = _build_library()
        except Exception as exc:
            _LIB_FAILED = True
            last_error = str(exc)
            log.warning("native frame loader unavailable: %s", exc)
    return _LIB


def native_available() -> bool:
    return _get_lib() is not None


def load_frames_native(
    paths: Sequence, image_size: int, n_threads: int = 0,
) -> Optional[np.ndarray]:
    """paths -> [N,3,S,S] float32 (ImageNet-normalized), or None on any
    failure (caller falls back to the PIL path)."""
    global last_backend, last_error
    lib = _get_lib()
    if lib is None:
        last_backend = "pil-fallback"
        return None
    encoded: List[bytes] = [str(p).encode() for p in paths]
    arr = (ctypes.c_char_p * len(encoded))(*encoded)
    out = np.empty((len(encoded), 3, image_size, image_size), np.float32)
    if n_threads <= 0:
        n_threads = min(len(encoded), os.cpu_count() or 4)
    rc = lib.vct_load_frames(
        arr, len(encoded), image_size,
        _IMAGENET_MEAN.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _IMAGENET_STD.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads,
    )
    if rc != 0:
        last_backend, last_error = "pil-fallback", f"decode failed for {paths[rc - 1]}"
        log.warning("native loader failed on %s; falling back to PIL", paths[rc - 1])
        return None
    last_backend, last_error = "native", None
    return out


def load_frames_native_u8(
    paths: Sequence, image_size: int, n_threads: int = 0,
) -> Optional[np.ndarray]:
    """paths -> [N,3,S,S] uint8 resized pixels (normalize on-device), or
    None on failure. Quarter the host->device bytes of the fp32 path."""
    global last_backend, last_error
    lib = _get_lib()
    if lib is None:
        last_backend = "pil-fallback"
        return None
    encoded: List[bytes] = [str(p).encode() for p in paths]
    arr = (ctypes.c_char_p * len(encoded))(*encoded)
    out = np.empty((len(encoded), 3, image_size, image_size), np.uint8)
    if n_threads <= 0:
        n_threads = min(len(encoded), os.cpu_count() or 4)
    rc = lib.vct_load_frames_u8(
        arr, len(encoded), image_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), n_threads,
    )
    if rc != 0:
        last_backend, last_error = "pil-fallback", f"decode failed for {paths[rc - 1]}"
        return None
    last_backend, last_error = "native", None
    return out


def load_frames_native_yuv420(
    paths: Sequence, image_size: int, n_threads: int = 0,
) -> Optional[np.ndarray]:
    """paths -> [N, packed_plane_len] uint8 raw 4:2:0 planes (Y | Cb | Cr per
    frame), or None when any frame is unsupported (not 4:2:0 YCbCr at exactly
    [image_size x image_size]) or fails to decode — the caller falls back to
    the RGB path. Finish the decode on-device with
    preprocessing.yuv420.yuv420_packed_to_rgb_chw (bit-exact with PIL):
    1.5 bytes/pixel on the wire instead of 3."""
    global last_backend, last_error
    lib = _get_lib()
    if lib is None:
        last_backend = "pil-fallback"
        return None
    cs = (image_size + 1) // 2
    plane_len = image_size * image_size + 2 * cs * cs
    encoded: List[bytes] = [str(p).encode() for p in paths]
    arr = (ctypes.c_char_p * len(encoded))(*encoded)
    out = np.empty((len(encoded), plane_len), np.uint8)
    if n_threads <= 0:
        n_threads = min(len(encoded), os.cpu_count() or 4)
    rc = lib.vct_load_frames_yuv420(
        arr, len(encoded), image_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), n_threads,
    )
    if rc != 0:
        idx = abs(rc) - 1
        reason = "unsupported (not 4:2:0 at target size)" if rc < 0 else "decode failed"
        last_backend, last_error = "rgb-fallback", f"{reason}: {paths[idx]}"
        return None
    last_backend, last_error = "native-yuv420", None
    return out
