"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the plain reference that decides ``correct``.

A run builds everything from ``--seed``: the weights (on the device, in one
draw), the frame pool (under the run's temporary directory), the traffic's
order and arrival times, the sample that is judged. It warms up the shapes
its traffic uses (``generator``), then measures for ``--seconds``. With
``--trace 0`` it reports the cell's end-to-end metrics; with ``--trace 1``
it also profiles a bounded slice of the window and reports the cell's
per-layer metrics, each read by ``metrics/<name>.py``, and the breakdown.

The benchmark's wrappers on the engine instance (``Recorder``) record the
ids of every decode group as the engine hands them to its text decoding
(``_collect_ids``), the videos each ``infer_batch_dispatch`` carries and
when. They add host work of microseconds a batch.

After the window: the peak device memory is read, the program is freed,
and the reference judges a seeded sample of the completed requests
(``reference/``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import statistics
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from caption_bench import flops, frames, generator, profiling, stats, weights
from caption_bench.reference import judge as ref_judge
from caption_bench.reference import model as ref_model

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "video_caption_tpu")
"""Top-level module names a run must not load (compared whole: the port's
name begins with the JAX package's)."""


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


# ---- the specification ----------------------------------------------------


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    mix: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def traffic_path(name: str, root: Path = ROOT) -> Path:
    return root / "caption_bench" / "traffic" / f"{name}.json"


def metric_path(name: str, root: Path = ROOT) -> Path:
    return root / "caption_bench" / "metrics" / f"{name}.py"


def resolve(spec: dict, workload: str, root: Path = ROOT,
            config_file: Optional[Path] = None) -> Cell:
    """The cell ``workload`` of ``spec`` with its configuration, its traffic
    mix and its metrics, each found by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((config_file or root / conf["file"]).read_text())
    mix = json.loads(traffic_path(w["traffic"], root).read_text())

    def listed(m: dict, fallback: bool) -> bool:
        return workload in m["workloads"] if "workloads" in m else fallback

    e2e = [m for m in spec["end_to_end"] if listed(m, True)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if listed(m, m["moves"] in names)]
    return Cell(workload, w["config"], config, w["traffic"], mix, w["chips"], e2e, per_layer)


def load_reader(name: str, root: Path = ROOT) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    path = metric_path(name, root)
    spec = importlib.util.spec_from_file_location(
        "caption_bench.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# ---- the recorder -----------------------------------------------------------


class Recorder:
    """Wraps ``infer``, ``infer_batch_dispatch`` and ``_collect_ids`` on one
    engine instance: the served ids of every video by directory, each
    dispatch's entry, exit and real videos (padding rows not counted), each
    completion, and the queue wait of requests with a due time."""

    def __init__(self, engine):
        self.lock = threading.Lock()
        self.served: Dict[str, Dict[int, List[int]]] = {}
        self.dispatches: List[tuple] = []
        self.completions: List[tuple] = []
        self.queue_wait_ms: List[tuple] = []
        self._due: Dict[str, float] = {}
        self._handles: Dict[int, tuple] = {}
        self._local = threading.local()
        dispatch, collect_ids, infer = (engine.infer_batch_dispatch, engine._collect_ids,
                                        engine.infer)

        def wrapped_dispatch(frames_dirs):
            t = time.perf_counter()
            handle = dispatch(frames_dirs)
            t1 = time.perf_counter()
            real = list(dict.fromkeys(frames_dirs))
            with self.lock:
                self._handles[id(handle)] = (handle, list(frames_dirs))
                self.dispatches.append((t, t1, len(real)))
                for d in real:
                    if d in self._due:
                        self.queue_wait_ms.append((t, (t - self._due[d]) * 1e3))
            return handle

        def wrapped_collect_ids(handle):
            out = collect_ids(handle)
            t = time.perf_counter()
            with self.lock:
                entry = self._handles.pop(id(handle), None)
            dirs = entry[1] if entry else [getattr(self._local, "frames_dir", None)]
            if dirs[0] is None:
                return out
            rows = {}
            for v, d in enumerate(dirs):
                if d in rows:
                    continue        # a bucket's padding repeats a request
                rows[d] = {idxs[j]: ids[v * len(idxs) + j].tolist()
                           for (_, idxs, _, _), ids in zip(handle.group_list, out)
                           for j in range(len(idxs))}
            with self.lock:
                self.served.update(rows)
                self.completions.append((t, len(rows)))
            return out

        def wrapped_infer(frames_dir):
            self._local.frames_dir = frames_dir
            try:
                return infer(frames_dir)
            finally:
                self._local.frames_dir = None

        engine.infer_batch_dispatch = wrapped_dispatch
        engine._collect_ids = wrapped_collect_ids
        engine.infer = wrapped_infer

    def set_due(self, due: Dict[str, float]) -> None:
        with self.lock:
            self._due.update(due)

    def reset(self) -> None:
        """Forget what the set-up served: only the window's requests count."""
        with self.lock:
            self.served.clear()
            self.dispatches.clear()
            self.completions.clear()
            self.queue_wait_ms.clear()


# ---- one run ------------------------------------------------------------------


def _seeds(seed: int, n: int) -> List[int]:
    ss = np.random.SeedSequence(int(seed) % (1 << 64))
    return [int(s) for s in ss.generate_state(n, dtype=np.uint64) % (1 << 63)]


class Bench:
    """Everything one run builds from its seed."""

    def __init__(self, cell: Cell, seed: int, seconds: float, device: str, tmp: Path,
                 control: bool = False):
        self.cfg, self.mix = cell.config, cell.mix
        self.seconds, self.tmp, self.control = seconds, tmp, control
        self.device = torch.device(device)
        (self.weights_seed, self.engine_seed, self.frames_seed, traffic_seed,
         self.sample_seed) = _seeds(seed, 5)
        self.rng = np.random.default_rng(traffic_seed)
        self.dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.cfg["dtype"]]
        self.presets = self.cfg["presets"]
        self.policies = [ref_judge.policy(p) for p in self.presets]
        eos = self.cfg["gpt2"]["eos_token_id"]
        self.prompt_lens = [len(ref_model.prompt_ids(p["prompt"], eos)) for p in self.presets]
        self.video_flops = flops.video_flops(self.cfg, self.prompt_lens, self.policies)
        self._linked = 0

    # -- inputs
    def build(self) -> None:
        t = time.perf_counter()
        self.pool = frames.make_pool(self.tmp / "pool", self.frames_seed, self.mix["pool"],
                                     self.cfg["num_frames"], self.cfg["vit"]["image_size"])
        self._clip_order = [int(i) for i in self.rng.permutation(len(self.pool))]
        self.frames_s = time.perf_counter() - t
        t = time.perf_counter()
        self.params = weights.make_params(self.cfg, self.weights_seed, self.device, self.dtype)
        self.weights_s = time.perf_counter() - t
        t = time.perf_counter()
        os.environ["VIDEO_CAPTION_VIDEO_CACHE_MB"] = str(self.cfg["video_cache_mb"])
        from video_caption_tpu_torch.engine import InferenceEngine

        self.engine = InferenceEngine(self.engine_config(), params=self.params,
                                      seed=self.engine_seed, model_cfg=self.model_config(),
                                      device=self.device)
        self.recorder = Recorder(self.engine)
        self.engine_s = time.perf_counter() - t

    def link_dirs(self, count: int):
        out = frames.link_dirs(self.tmp / "requests", self.pool, count, self._clip_order,
                               start=self._linked)
        self._linked += count
        return out

    def payload(self, frames_dir: str) -> dict:
        """The request body that asks for this configuration."""
        body = {"frames_dir": frames_dir, "ckpt": str(self.tmp / "no_checkpoint.pt"),
                "num_frames": self.cfg["num_frames"],
                "image_size": self.cfg["vit"]["image_size"],
                "prefix_len": self.cfg["prefix_len"], "ln_scale": self.cfg["ln_scale"],
                "in_weight": self.cfg["in_weight"], "compute_dtype": self.cfg["dtype"]}
        for i, p in enumerate(self.presets, start=1):
            body[f"preset{i}"], body[f"prompt{i}"] = p["name"], p["prompt"]
        return body

    def request_config(self):
        from video_caption_tpu_torch.server.schemas import InferRequest
        from video_caption_tpu_torch.server.services.inference_service import request_to_config

        return request_to_config(InferRequest.from_payload(self.payload("")))

    def engine_config(self):
        """The engine's configuration: the server's mapping of this
        configuration's request (so the server finds this engine), with the
        program's int8 path on for the control."""
        config = self.request_config()
        compile_cfg = dataclasses.replace(config.compile, quantize_decoder_int8=self.control)
        return dataclasses.replace(config, compile=compile_cfg)

    def model_config(self):
        """The engine's model configuration at this configuration's sizes."""
        from video_caption_tpu_torch.engine import model_config_from_inference

        mc = model_config_from_inference(self.engine_config())
        v, g = self.cfg["vit"], self.cfg["gpt2"]
        vit = dataclasses.replace(mc.vit, image_size=v["image_size"], patch_size=v["patch_size"],
                                  in_chans=v["in_chans"], embed_dim=v["embed_dim"],
                                  depth=v["depth"], num_heads=v["num_heads"],
                                  mlp_ratio=v["mlp_ratio"], out_dim=v["out_dim"], pool="cls")
        gpt2 = dataclasses.replace(mc.gpt2, vocab_size=g["vocab_size"],
                                   max_position_embeddings=g["n_positions"], n_embd=g["n_embd"],
                                   n_layer=g["n_layer"], n_head=g["n_head"])
        return dataclasses.replace(mc, vit=vit, gpt2=gpt2, prefix_len=self.cfg["prefix_len"],
                                   video_dim=self.cfg["video_dim"])

    # -- the program's kernel calls (traced runs)
    def log_ops(self) -> Optional[Dict[str, tuple]]:
        """{op: (calls, bound seconds)} of one eager run of the program the
        cell's batches replay (``engine._program_for``: what the batch's
        graph captured), or None for cells that are not batch loops."""
        if self.mix["loop"] != "batch_pipelined" or self.device.type != "cuda":
            return None
        pk = flops.peaks(torch.cuda.get_device_name(self.device))
        if pk is None:
            return None
        b = self.mix["batch"]
        video = torch.cat([self.engine.load_video(d) for d in self.pool[:b]])
        program, _ = self.engine._program_for(b)
        with profiling.OpLog() as log:
            program(video)
        torch.cuda.synchronize(self.device)
        return log.bounds(pk)


@dataclass
class Readings:
    """What the per-layer readers read (``metrics/<name>.py``: ``read(run)``
    returns a number, or None where the run has nothing to read)."""

    family: str
    slice: Optional[profiling.Slice]
    outcome: generator.Outcome
    dispatch_videos: List[int]
    queue_wait_ms: List[float]
    latency_ms: List[float]
    """Open loop: the latency of each request answered before the slice."""
    op_bounds: Optional[Dict[str, tuple]]
    peaks: Optional[Dict[str, float]]
    batch: Optional[int]


def _profile_factory(bench: Bench, profiled: list):
    """The loop's ``profile(videos, requests, replays)``: a context that
    profiles its block and keeps it, with what the loop knows ran in it
    (None: the videos whose batch completed inside it), for
    ``_reduce_slices`` after the window."""
    from video_caption_tpu_torch import aot
    from video_caption_tpu_torch.ops import build

    @contextlib.contextmanager
    def profile(videos, requests, replays):
        prof = profiling.Profiler(build.KERNELS, aot.launch_counts)
        with prof:
            yield
        profiled.append((prof, videos, requests, replays))

    return profile


def _reduce_slices(bench: Bench, profiled: list) -> List[profiling.Slice]:
    out = []
    for prof, videos, requests, replays in profiled:
        s = prof.reduce()
        if videos is None:
            done = [n for t, n in bench.recorder.completions if s.start <= t <= s.end]
            videos, requests = sum(done), len(done)
        s.videos, s.requests, s.replays = videos, requests, replays
        s.model_flops = videos * bench.video_flops
        out.append(s)
    return out


def _warm_profiler() -> None:
    """Start and stop the profiler once: its first start in a process
    (CUPTI's) is slow, and belongs in the set-up of a traced run."""
    from video_caption_tpu_torch.ops import build

    prof = profiling.Profiler(build.KERNELS)
    with prof:
        torch.zeros(1, device="cuda").add_(1)


def end_to_end(cell: Cell, outcome: generator.Outcome, setup_s: float) -> Dict[str, float]:
    values = {"setup_s": setup_s}
    if outcome.done_s:
        # open loop: the requests answered inside the window
        inside = sum(1 for t in outcome.done_s if t <= outcome.window_s)
        values["served_per_s"] = stats.rate(inside, outcome.window_s)
    elif outcome.videos_done:
        values["captions_per_s"] = stats.rate(outcome.videos_done, outcome.window_s)
    return values


def judge(bench: Bench, served: Dict[str, Dict[int, List[int]]], sample: List[str]) -> dict:
    """The reference's verdict on ``sample``'s served rows: every row's
    gaps (``reference/judge.py``), summarised."""
    cfg, dev = bench.cfg, bench.device
    eos = cfg["gpt2"]["eos_token_id"]
    w32 = _float32(bench.params)
    gaps = {}
    with ref_model.exact_float32(), torch.no_grad():
        for d in sample:
            pixels = torch.from_numpy(ref_model.decode_frames(
                d, cfg["num_frames"], cfg["vit"]["image_size"])).to(dev)
            emb = ref_model.vit_embedding(w32["encoder"], pixels, cfg["vit"])
            prefix = ref_model.prefix_embeddings(w32, emb, cfg)
            for i, (p, pol) in enumerate(zip(bench.presets, bench.policies)):
                row = served[d].get(i)
                if row is None or len(row) != pol.max_new_tokens:
                    gaps[(d, i)] = [math.inf]
                    continue
                n = ref_judge.evaluated_length(row, eos)
                ids = ref_model.prompt_ids(p["prompt"], eos)
                logits = ref_model.row_logits(w32, prefix, ids, row[:n], cfg["gpt2"])
                gaps[(d, i)] = ref_judge.row_gaps(logits, row, pol, eos)
    del w32
    return ref_judge.summarize(gaps)


def _float32(tree):
    return {k: _float32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: bool = False, hook: Optional[Callable] = None,
             t_start: Optional[float] = None) -> dict:
    """One run; returns the result line as a dict (``run.py`` prints it).
    ``hook(bench)`` runs after the engine is built (tests plant faults
    there); ``control`` serves with the program's int8 path on."""
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory(prefix="caption_bench_") as tmp:
        bench = Bench(cell, seed, seconds, device, Path(tmp), control=control)
        bench.build()
        if hook is not None:
            hook(bench)
        loop = generator.make(bench, cell.mix)
        t = time.perf_counter()
        try:
            loop.setup()
            loop_setup_s = time.perf_counter() - t
            op_bounds = bench.log_ops() if trace else None
            if trace and cuda:
                _warm_profiler()
            bench.recorder.reset()
            if cuda:
                torch.cuda.synchronize(bench.device)
            setup_s = time.perf_counter() - t_start
            profiled: list = []
            outcome = loop.run(seconds, _profile_factory(bench, profiled) if trace else None)
        finally:
            loop.close()
        slices = _reduce_slices(bench, profiled)
        peak = torch.cuda.max_memory_allocated(bench.device) if cuda else 0
        name = torch.cuda.get_device_name(bench.device) if cuda else "cpu"
        print(f"setup: frames {bench.frames_s:.3f} s, weights {bench.weights_s:.3f} s, engine "
              f"{bench.engine_s:.3f} s, warm-up {loop_setup_s:.3f} s, total {setup_s:.3f} s",
              file=sys.stderr)
        for err in outcome.errors[:5]:
            print(f"request error: {err}", file=sys.stderr)
        if outcome.latencies_s:
            lat_ms = [x * 1e3 for x in outcome.latencies_s]
            print(f"latency: p50 {statistics.median(lat_ms):.3f} ms, p95 "
                  f"{stats.percentile(lat_ms, 95):.3f} ms, max {max(lat_ms):.3f} ms over "
                  f"{len(lat_ms)} requests", file=sys.stderr)
        if outcome.late_s:
            print(f"open loop sent late: p50 {statistics.median(outcome.late_s) * 1e3:.3f} ms, "
                  f"max {max(outcome.late_s) * 1e3:.3f} ms", file=sys.stderr)
        if outcome.done_s and len(outcome.latencies_s) >= 4:
            # a queue that grows through the window shows as rising quarters
            q = len(lat_ms) // 4
            quarters = [statistics.median(lat_ms[i * q:(i + 1) * q]) for i in range(4)]
            inside = sum(1 for t in outcome.done_s if t <= outcome.window_s)
            print(f"open loop: p50 by quarter of the arrivals "
                  f"{', '.join(f'{x:.3f}' for x in quarters)} ms; {inside} of "
                  f"{outcome.attempted} answered inside the window", file=sys.stderr)
        if bench.recorder.dispatches:
            d = bench.recorder.dispatches
            print(f"dispatches: {len(d)}, {statistics.fmean(n for *_, n in d):.3f} videos and "
                  f"{statistics.fmean((t1 - t) * 1e3 for t, t1, _ in d):.3f} host ms each",
                  file=sys.stderr)

        result = {"correct": False, "attempted": outcome.attempted, "failed": outcome.failed}
        slice_ = slices[0] if slices else None
        if slice_ is not None:
            held = {w: f"{slice_.traced_calls(w)}/{n}" for w, n in slice_.launches.items()}
            print(f"trace: {slice_.kernels} kernels; launches held/counted {held}; "
                  f"{'complete' if slice_.complete else 'events dropped'}", file=sys.stderr)
        family = generator.FAMILY[cell.mix["loop"]]
        if trace:
            # the server's counters before the slice: profiling stalls the
            # live load while it starts and stops
            until = slice_.start if slice_ is not None else math.inf
            readings = Readings(
                family=family, slice=slice_, outcome=outcome,
                dispatch_videos=[n for t, _, n in bench.recorder.dispatches if t < until],
                queue_wait_ms=[w for t, w in bench.recorder.queue_wait_ms if t < until],
                latency_ms=[x * 1e3 for x, t in zip(outcome.latencies_s, outcome.done_s)
                            if outcome.t0 + t < until],
                op_bounds=op_bounds, peaks=flops.peaks(name), batch=cell.mix.get("batch"))
            metrics = {}
            for m in cell.per_layer:
                value = load_reader(m["name"])(readings)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            values = end_to_end(cell, outcome, setup_s)
            metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                       for m in cell.end_to_end if m["name"] in values}
        result["metrics"] = metrics
        result["device"] = {"platform": "gpu" if cuda else "cpu", "kind": name,
                            "count": 1, "memory_peak_bytes": int(peak)}
        if trace and slice_ is not None:
            result["device"]["busy_s"] = slice_.busy_s
            result["device"]["window_s"] = slice_.wall_s
            result["breakdown"] = {"device_ops": [list(x) for x in slice_.device_ops],
                                   "idle_gaps": [list(x) for x in slice_.idle_gaps]}

        # the program's state goes before the reference runs
        served = dict(bench.recorder.served)
        done = sorted(served)
        rng = np.random.default_rng(bench.sample_seed)
        count = min(cell.mix["judged"], len(done))
        sample = [done[i] for i in sorted(rng.choice(len(done), count, replace=False))]
        del loop, bench.engine, bench.recorder
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        verdict = judge(bench, served, sample)
        judge_s = time.perf_counter() - t
        checks = {
            "mean_gap": {"value": verdict["mean_gap"],
                         "limit": cell.mix["limits"]["mean_gap"]},
            "failed_requests": {"value": outcome.failed, "limit": 0},
            "unjudged_requests": {"value": cell.mix["judged"] - len(sample), "limit": 0},
        }
        result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
        print(f"judged {len(sample)} requests, {verdict['tokens']} tokens in "
              f"{judge_s:.3f} s; share outside the admitted set {verdict['outside']:.6f}, "
              f"widest gap {verdict['max_gap']:.6f}", file=sys.stderr)
        for key, c in checks.items():
            print(f"check {key}: {c['value']} <= {c['limit']}", file=sys.stderr)
        result["checks"] = checks
        result["_diagnostics"] = {"outside": verdict["outside"], "max_gap": verdict["max_gap"],
                                  "tokens": verdict["tokens"], "judge_s": judge_s}
        return result


def main(args, t_start: float) -> int:
    """The command line's run: refuse without the chips the cell asks for,
    run, refuse a run that loaded JAX or the JAX package, print the line."""
    spec = load_spec()
    cell = resolve(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"caption_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"caption_bench: the run loaded {found}", file=sys.stderr)
        return 3
    result.pop("_diagnostics", None)
    print(json.dumps(result), flush=True)
    return 0
