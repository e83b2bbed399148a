"""The knee of the served cell: the highest offered rate the server
sustains, found once by a sweep on the card.

    python3 caption_bench/sweep.py --workload serving.open --rates 20,30,40 \\
        [--seconds 10] [--seed 7]

One engine and one server (the cell's configuration and traffic mix, its
queue settings); for each rate in turn, a window of ``--seconds`` of
Poisson arrivals (each request a new clip). Prints one JSON line a rate:
offered and achieved rate (completions over the span from the first to
the last), p50 / p95 / p99 latency from the due time, failures, and
whether the gates of ``bench/serving_load.py`` hold (achieved >= 0.97 x
offered, p99 <= 2 s). The cell's rate is written into its traffic file by
hand, at about 0.8 of the highest rate that passes.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="serving.open")
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    for key in [k for k in os.environ if k.startswith("VIDEO_CAPTION_")]:
        del os.environ[key]
    os.environ["VIDEO_CAPTION_TORCH_BUILD_DIR"] = str(ROOT / "build" / "cuda_kernels")
    os.environ["VIDEO_CAPTION_TORCH_NATIVE_CACHE"] = str(ROOT / "build" / "native")
    sys.path.insert(0, str(ROOT))
    import torch

    from caption_bench import generator, harness, stats

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.resolve(harness.load_spec(), args.workload)
    if cell.mix["loop"] != "open_poisson":
        print("sweep: the workload is not an open loop", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="caption_bench_") as tmp:
        bench = harness.Bench(cell, args.seed, args.seconds, "cuda", Path(tmp))
        bench.build()
        loop = generator.make(bench, cell.mix)
        try:
            loop.setup()
            for rate in (float(r) for r in args.rates.split(",")):
                loop.schedule(rate, args.seconds)
                out = loop.run(args.seconds, None)
                lat = [x * 1e3 for x in out.latencies_s]
                done = sorted(out.done_s)
                achieved = (stats.rate(len(done) - 1, done[-1] - done[0]) if len(done) > 1
                            else 0.0)
                p99 = stats.percentile(lat, 99) if lat else float("inf")
                print(json.dumps({
                    "offered_per_s": rate, "achieved_per_s": achieved, "requests": out.attempted,
                    "failed": out.failed, "p50_ms": statistics.median(lat) if lat else None,
                    "p95_ms": stats.percentile(lat, 95) if lat else None, "p99_ms": p99,
                    "late_p50_ms": statistics.median(out.late_s) * 1e3 if out.late_s else None,
                    "passes": achieved >= 0.97 * rate and p99 <= 2000.0 and not out.failed}),
                    flush=True)
        finally:
            loop.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
