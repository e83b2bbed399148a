"""Run one cell of BENCHMARK.json once and print its result as one JSON line.

    python3 caption_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA devices the cell
asks for (without them it prints no result and exits with 2). The last line
of standard output is ``{"correct", "attempted", "failed", "metrics",
"device", ["breakdown"], "checks"}``; the numbers compared for ``correct``
close standard error too. Kernel builds go to ``build/`` inside the
checkout, at fixed paths.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # the program reads VIDEO_CAPTION_* switches from the environment: a run
    # takes the configuration file's values alone
    for key in [k for k in os.environ if k.startswith("VIDEO_CAPTION_")]:
        del os.environ[key]
    os.environ["VIDEO_CAPTION_TORCH_BUILD_DIR"] = str(ROOT / "build" / "cuda_kernels")
    os.environ["VIDEO_CAPTION_TORCH_NATIVE_CACHE"] = str(ROOT / "build" / "native")
    sys.path.insert(0, str(ROOT))
    from caption_bench import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
