"""Environment health check (counterpart of
video_caption_tpu/cli/check_env.py): dependency groups, GPU visibility,
device memory, import health of the port's own modules.

Usage: python -m video_caption_tpu_torch.cli.check_env [--require-gpu]
"""
from __future__ import annotations

import argparse
import importlib
import sys


CORE_MODULES = (
    "video_caption_tpu_torch.config", "video_caption_tpu_torch.engine",
    "video_caption_tpu_torch.models.caption_model", "video_caption_tpu_torch.decode.generate",
    "video_caption_tpu_torch.data.data_loader", "video_caption_tpu_torch.bench.benchmark",
    "video_caption_tpu_torch.server.stdlib_server",
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--require-gpu", action="store_true")
    args = p.parse_args(argv)
    failures = 0

    from video_caption_tpu_torch.env import (
        RuntimeNotReady, assert_core_runtime_ready, device_summary,
    )

    try:
        assert_core_runtime_ready(require_gpu=args.require_gpu)
        print("[ok] core dependencies")
    except RuntimeNotReady as err:
        print(f"[FAIL] {err}")
        failures += 1

    for mod in CORE_MODULES:
        try:
            importlib.import_module(mod)
            print(f"[ok] import {mod}")
        except ImportError as err:
            print(f"[FAIL] import {mod}: {err}")
            failures += 1

    info = device_summary()
    print(f"[ok] torch {info['torch_version']} cuda {info['cuda_version']} "
          f"backend={info['backend']} devices={info['num_devices']} kind={info['device_kind']}"
          + (f" ({info['nvidia_smi']})" if info["nvidia_smi"] else ""))

    if info["backend"] == "cuda":
        from video_caption_tpu_torch.memory import MemoryManager

        snap = MemoryManager().snapshot()
        print(f"[ok] device memory: {snap.bytes_in_use / 2**20:.0f} MiB in use, "
              f"{snap.bytes_reserved / 2**20:.0f} MiB reserved of {snap.bytes_limit / 2**20:.0f}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
