"""Build and load the hand-written Hopper kernels (``ops/csrc/*.cu``).

On first use the CUDA sources are compiled with ``nvcc``, one process per
source, all started together, and linked into one shared library with a
plain C interface, in a build directory keyed by a hash of the sources and
flags, and loaded with ``ctypes``. Every pointer and the stream pass as
``c_void_p``, every integer as ``c_int`` (an element count that may pass
2**31 as ``c_longlong``), a float as ``c_float``. Each C
entry point returns the ``cudaError_t`` of its launch; :func:`launch` raises
on anything but 0.

There is no fallback here: a failed build or launch raises. The CPU path of
each kernel is its plain PyTorch version, chosen by the wrapper because its
tensor lies on the CPU, never because the kernel failed.

The build directory is ``build/cuda_kernels`` at the root of the checkout
(listed in ``.gitignore``); ``VIDEO_CAPTION_TORCH_BUILD_DIR`` moves it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

SRC_DIR = Path(__file__).resolve().with_name("csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry point -> argument types (ops/csrc/*.cu)
SIGNATURES: Dict[str, List] = {
    "vct_encoder_attention": [_P, _P, _I, _I, _I, _I, _I, _P],
    "vct_prefix_project": [_P, _P, _P, _P] + [_I] * 9 + [_P],
    "vct_lm_head_stats": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vct_beam_attention": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P] + [_I] * 11 + [_P],
    "vct_decode_attention": [_P, _I, _P, _I, _I, _P, _I, _I, _P, _P] + [_I] * 7 + [_P],
    "vct_decode_layer": [_P] * 22 + [_I] * 6 + [_F] + [_I] * 11 + [_P],
    "vct_fused_pool": [_P, _P] + [_I] * 10 + [_P],
    "vct_layer_norm": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
    "vct_gelu": [_P, _P, _L, _I, _P],
}

# the __global__ functions of ops/csrc/*.cu (each in an anonymous namespace)
KERNELS = frozenset({
    "attention_bf16_kernel", "attention_f32_kernel", "prefix_projector_kernel",
    "lm_head_mma_kernel", "lm_head_window_f32_kernel", "lm_head_row_stats_kernel",
    "beam_attention_kernel", "decode_attention_kernel", "decode_layer_kernel",
    "fused_pool_kernel", "layer_norm_vec_kernel", "layer_norm_kernel", "gelu_kernel",
})

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
"""Wall time of the nvcc build in this process (None if the library was
already built, or not yet loaded)."""


def build_dir() -> Path:
    env = os.environ.get("VIDEO_CAPTION_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "cuda_kernels"


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def sources() -> List[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build(lib_path: Path) -> None:
    """Compile every source (one nvcc each, in parallel) and link them into
    ``lib_path`` (atomically: a concurrent build of the same sources writes
    the same bytes under its own temporary names)."""
    global build_seconds
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    nvcc = nvcc_path()
    start = time.perf_counter()
    jobs = []
    for src in sources():
        obj = lib_path.with_name(f"{tag}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    tmp = lib_path.with_name(f"{tag}.tmp.so")
    link = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (exit {proc.returncode}):\n{out[-4000:]}")
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    build_seconds = time.perf_counter() - start
    lib_path.with_suffix(".log").write_text("\n".join(log))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib_path)


def library_path() -> Path:
    return build_dir() / f"libvct_kernels_{_digest()}.so"


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.vct_error_string.argtypes = [ctypes.c_int]
            lib.vct_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def build_log() -> str:
    """nvcc's output for the current sources (register and shared-memory
    use per kernel from -Xptxas=-v), or '' before the first build."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.is_file() else ""


SASS_PATTERNS = {
    "HMMA/HGMMA": r"HG?MMA",                  # tensor-core products
    "LDG.128": r"\bLDG\.E(\.\w+)*\.128\b",   # 16-byte global loads
    "LD": r"\bLD\.E\b",                       # generic loads (fused_pool: a cluster peer's shared memory)
    "UCGABAR": r"\bUCGABAR_ARV\b",             # cluster barrier arrivals
    "LDGSTS": r"\bLDGSTS\b",                   # cp.async copies, global to shared
}
"""Instructions counted per kernel in the built library's SASS."""


def sass() -> str:
    """``cuobjdump -sass`` of the built library (cuobjdump beside nvcc)."""
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(library_path())], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def count_instructions(listing: str, patterns: Dict[str, str]) -> Dict[str, Dict[str, int]]:
    """{function: {name: lines matching patterns[name]}} of a ``cuobjdump
    -sass`` listing."""
    compiled = {name: re.compile(p) for name, p in patterns.items()}
    counts: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in listing.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = dict.fromkeys(patterns, 0)
        elif fn is not None:
            for name, rx in compiled.items():
                counts[fn][name] += bool(rx.search(line))
    return counts



def dtype_code(dtype: torch.dtype) -> int:
    """The dtype code the C entry points take (csrc/common.cuh)."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {dtype}")


def stream_of(t: torch.Tensor) -> int:
    """The handle of the current stream on ``t``'s device. Read raw: the
    public ``torch.cuda.current_stream(...).cuda_stream`` builds a Stream
    object first, host time on every launch, and the decode loops that
    launch these kernels are bound by the host."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def launch(name: str, *args) -> None:
    """Call a C entry point; raise if its launch reported a CUDA error."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} ({lib.vct_error_string(rc).decode()})")


def require_device(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on the CPU (the op's plain version) or
    on a CUDA device (its kernel): a wrapper hands nothing else to its op,
    whose fake implementation would answer a meta tensor with one."""
    for t in tensors:
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"the kernels take CPU or CUDA tensors, got one on {t.device}")


def require_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
