"""Dependency and device gates, and the environment fingerprint of every
report (counterpart of video_caption_tpu/env.py).

Named dependency groups are asserted before a model loads; the GPU check
replaces the JAX package's TPU check. The JAX package's
``enable_compilation_cache`` (a persistent XLA cache of compiled programs)
has no counterpart: nothing here is compiled by XLA. The port's kernels
are built once per source hash into ``build/cuda_kernels/`` (ops/build.py)
and its request programs are CUDA graphs, which hold device pointers and
live only in their process.
"""
from __future__ import annotations

import importlib
import shutil
import subprocess
from typing import Iterable, Optional


class RuntimeNotReady(RuntimeError):
    pass


_CORE_DEPS = ("torch", "numpy", "PIL")
_FRONTEND_DEPS = ("httpx",)


def _assert_importable(names: Iterable[str], group: str) -> None:
    missing = []
    for name in names:
        try:
            importlib.import_module(name)
        except ImportError:
            missing.append(name)
    if missing:
        raise RuntimeNotReady(f"missing {group} dependencies: {', '.join(missing)}")


def assert_core_runtime_ready(require_gpu: bool = False) -> None:
    _assert_importable(_CORE_DEPS, "core")
    if require_gpu:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeNotReady("an NVIDIA GPU is required but torch.cuda.is_available() "
                                  "is false")


def assert_server_runtime_ready() -> None:
    """The port serves through its standard-library server
    (server/stdlib_server.py): the core dependencies are all it needs."""
    assert_core_runtime_ready()


def assert_frontend_runtime_ready() -> None:
    """The frontend's REST client (frontend/api_client.py) posts through
    httpx; without it the client falls back to urllib, but this gate, as the
    JAX package's, asks for httpx."""
    _assert_importable(_FRONTEND_DEPS, "frontend")


def nvidia_smi() -> Optional[str]:
    """The card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (first card); None where there is no nvidia-smi."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_summary(device=None) -> dict:
    """Environment fingerprint for reports: torch and CUDA versions, the
    device the numbers were taken on (the card unless ``device`` names the
    CPU, or no card is visible), its name, the device count, and the
    card's name and power limit from nvidia-smi."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    on_gpu = device.type == "cuda"
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": device.type,
        "num_devices": torch.cuda.device_count(),
        "device_kind": torch.cuda.get_device_name(device) if on_gpu else "cpu",
        "nvidia_smi": nvidia_smi() if on_gpu else None,
    }
