"""The readings that a cell's limits are set from, on the card.

    python3 caption_bench/control.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 101,102,103] [--faults token,half,stale] \\
        [--seconds 4] [--out FILE]

In one process, for each seed: one run of the cell (``harness.run_cell``,
the cell's own traffic and sizes, a short window) as the program serves it
(the lower readings), then on each control seed with the program's int8
path on (``compile.quantize_decoder_int8``: the step below the bf16 the
configuration states, the control), then on each control seed with each
planted fault (``faults.py``). Prints one JSON line a run: the numbers compared, the
share of judged tokens outside their admitted set, and whether the run is
``correct`` under the limits in force. The benchmark's own runs never run
this.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    for key in [k for k in os.environ if k.startswith("VIDEO_CAPTION_")]:
        del os.environ[key]
    os.environ["VIDEO_CAPTION_TORCH_BUILD_DIR"] = str(ROOT / "build" / "cuda_kernels")
    os.environ["VIDEO_CAPTION_TORCH_NATIVE_CACHE"] = str(ROOT / "build" / "native")
    sys.path.insert(0, str(ROOT))
    import torch

    from caption_bench import faults, harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.resolve(harness.load_spec(), args.workload)
    runs = [(int(s), "program") for s in args.seeds.split(",") if s]
    runs += [(int(s), "control") for s in args.control_seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    runs += [(s, f) for f in args.faults.split(",") if f for s in control_seeds]
    out = open(args.out, "a") if args.out else None
    for seed, kind in runs:
        t = time.perf_counter()
        try:
            if kind in faults.FAULTS:
                with faults.FAULTS[kind]():
                    r = harness.run_cell(cell, seed, args.seconds, False)
            else:
                r = harness.run_cell(cell, seed, args.seconds, False, control=kind == "control")
            line = {"workload": args.workload, "seed": seed, "kind": kind,
                    "correct": r["correct"], "attempted": r["attempted"], "failed": r["failed"],
                    "checks": r["checks"], **r["_diagnostics"],
                    "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                    "seconds": time.perf_counter() - t}
        except Exception as exc:  # a control that crashes has failed
            line = {"workload": args.workload, "seed": seed, "kind": kind, "error": repr(exc)}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
