"""The traffic generator: one module that reads a traffic mix
(``traffic/<name>.json``) and drives the program through the entry point
the mix's ``loop`` names.

- ``batch_pipelined``: a closed loop of batches of ``batch`` distinct
  videos through ``infer_batch_dispatch`` / ``infer_batch_collect`` with
  ``depth`` batches in flight (batch N+1 dispatched before batch N is
  collected: ``tools/batch_infer.py``'s and ``bench/driver.py``'s loop),
  over the pool's clips, loaded into the device video cache in set-up, in a
  seeded order.
- ``open_poisson``: requests at ``rate_per_s`` through POST /api/v1/infer
  of the port's stdlib server, started in this process; a new directory
  every request. The arrival times are a Poisson process conditioned on its
  count (``round(rate * seconds)`` times drawn uniformly over the window and
  sorted) drawn once from a fixed stream; the seed orders its gaps. So every
  seed sends the same requests at the same set of gaps and ends its arrivals
  at the same time: the work does not move with the seed, only its order. A
  request is timed from when it was due. The client is a process of its own
  (``client.py``: one thread, asyncio), so the load takes no share of the
  server's interpreter.

Every loop warms up in ``setup`` exactly the shapes its window uses, counts
attempts and failures, and records spans (``bench.*``) for the trace.
"""
from __future__ import annotations

import http.client
import json
import subprocess
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
from torch.profiler import record_function

ROOT = Path(__file__).resolve().parents[1]
GAPS_SEED = 20
"""The fixed stream of the open loop's arrival gaps."""


@dataclass
class Outcome:
    window_s: float
    t0: float = 0.0
    """The window's start (``time.perf_counter``)."""
    attempted: int = 0
    failed: int = 0
    videos_done: int = 0
    """Videos whose captions completed inside the window."""
    latencies_s: List[float] = field(default_factory=list)
    dispatch_ms: List[float] = field(default_factory=list)
    late_s: List[float] = field(default_factory=list)
    """How late each open-loop request was sent after it was due."""
    done_s: List[float] = field(default_factory=list)
    """When each request completed, from the window's start."""
    errors: List[str] = field(default_factory=list)


PATH = "/api/v1/infer"

FAMILY = {"batch_pipelined": "batch", "open_poisson": "served"}
"""Loop -> the family of per-layer metrics its cells report."""


class Loop:
    """Base of the loops. ``bench`` is the harness's ``Bench``: the
    engine, the recorder, the frame pool and the seeded random streams."""

    def __init__(self, bench, mix: dict):
        self.bench, self.mix = bench, mix
        self.engine = bench.engine
        self._next_dir = 0
        self._dirs: List[str] = []

    def new_dirs(self, count: int) -> List[str]:
        """``count`` directories the engine has not seen."""
        while self._next_dir + count > len(self._dirs):
            more = max(count, int(self.mix.get("dirs_per_s", 100) * 2))
            self._dirs += [d for d, _ in self.bench.link_dirs(more)]
        out = self._dirs[self._next_dir:self._next_dir + count]
        self._next_dir += count
        return out

    def setup(self) -> None:
        raise NotImplementedError

    def run(self, seconds: float, profile: Optional[Callable]) -> Outcome:
        raise NotImplementedError

    def close(self) -> None:
        pass


class BatchPipelined(Loop):
    def setup(self) -> None:
        b = self.mix["batch"]
        pool = self.bench.pool
        if len(pool) % b:
            raise ValueError("the pool must hold whole batches")
        # every clip into the device video cache; the first batch captures
        for start in range(0, len(pool), b):
            self.engine.infer_batch(pool[start:start + b])
        self.engine.infer_batch(pool[:b])
        self._order = deque()

    def next_batch(self) -> List[str]:
        b = self.mix["batch"]
        if len(self._order) < b:
            self._order.extend(int(i) for i in self.bench.rng.permutation(len(self.bench.pool)))
        return [self.bench.pool[self._order.popleft()] for _ in range(b)]

    def run(self, seconds: float, profile: Optional[Callable]) -> Outcome:
        out = Outcome(window_s=seconds)
        depth = self.mix["depth"]
        pending = deque()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        sliced = profile is None

        def collect_one():
            handle, n = pending.popleft()
            try:
                with record_function("bench.collect"):
                    self.engine.infer_batch_collect(handle)
            except Exception as exc:  # counted, not raised: the window goes on
                out.failed += n
                out.errors.append(repr(exc))
                return
            if time.perf_counter() <= deadline:
                out.videos_done += n

        def dispatch_one():
            dirs = self.next_batch()
            out.attempted += len(dirs)
            t = time.perf_counter()
            try:
                with record_function("bench.dispatch"):
                    handle = self.engine.infer_batch_dispatch(dirs)
            except Exception as exc:
                out.failed += len(dirs)
                out.errors.append(repr(exc))
                return
            out.dispatch_ms.append((time.perf_counter() - t) * 1e3)
            pending.append((handle, len(dirs)))

        while time.perf_counter() < deadline:
            if not sliced and time.perf_counter() >= t0 + seconds / 3:
                sliced = True
                while pending:
                    collect_one()
                batches = self.mix["slice_batches"]
                with profile(videos=batches * self.mix["batch"], requests=batches,
                             replays={self.mix["batch"]: batches}):
                    for _ in range(batches):
                        dispatch_one()
                        if len(pending) >= depth:
                            collect_one()
                    while pending:
                        collect_one()
                continue
            dispatch_one()
            if len(pending) >= depth:
                collect_one()
        while pending:
            collect_one()
        return out


class OpenPoisson(Loop):
    """Requests over HTTP to the port's stdlib server on this host."""

    def setup(self) -> None:
        from video_caption_tpu_torch.server.services import batching_queue
        from video_caption_tpu_torch.server.services.model_registry import MODEL_REGISTRY
        from video_caption_tpu_torch.server.stdlib_server import StdlibServer

        # the server looks its engine up by the request's configuration and
        # its queue up by the engine: both point at this run's engine
        self._key = self.bench.request_config().cache_key()
        MODEL_REGISTRY._engines[self._key] = self.engine
        self.queue = batching_queue.get_queue(self.engine, max_batch=self.mix["max_batch"],
                                              max_wait_ms=self.mix["max_wait_ms"])
        self.server = StdlibServer(host="127.0.0.1", port=0).start()
        # every bucket the queue forms, captured before the window
        size = 1
        while size <= self.mix["max_batch"]:
            self.engine.infer_batch(self.new_dirs(size))
            size *= 2
        for d in self.new_dirs(self.mix["warmup_requests"]):
            status, _ = self._post(d)
            if status != 200:
                raise RuntimeError(f"warm-up request answered {status}")
        # the cell's own load for a few seconds: the allocator grows to the
        # batches' mix of sizes here, not inside the window
        self.schedule(self.mix["rate_per_s"], self.mix["warmup_seconds"])
        self.run(self.mix["warmup_seconds"], None)
        self.schedule(self.mix["rate_per_s"], self.bench.seconds)

    def schedule(self, rate: float, seconds: float) -> None:
        """The next window's arrival times and new directories."""
        count = round(rate * seconds)
        times = np.sort(np.random.default_rng([GAPS_SEED, count]).uniform(0.0, seconds, count))
        gaps = np.diff(times, prepend=0.0)
        self.due = np.cumsum(gaps[self.bench.rng.permutation(count)])
        self.request_dirs = self.new_dirs(count)

    def _post(self, frames_dir: str):
        """One request from this process (the set-up's warm-up)."""
        body = json.dumps(self.bench.payload(frames_dir)).encode()
        conn = http.client.HTTPConnection(self.server.host, self.server.port, timeout=120)
        try:
            conn.request("POST", PATH, body, {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
        finally:
            conn.close()
        return resp.status, data

    def run(self, seconds: float, profile: Optional[Callable]) -> Outcome:
        out = Outcome(window_s=seconds)
        count = len(self.due)
        bodies = [json.dumps(self.bench.payload(d)) for d in self.request_dirs]
        proc = subprocess.Popen(
            [sys.executable, "-m", "caption_bench.client", self.server.host,
             str(self.server.port), PATH, str(seconds + 60.0)],
            cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        try:
            if proc.stdout.readline().strip() != "ready":
                raise RuntimeError("the client process did not start")
            t0 = out.t0 = time.perf_counter() + 0.2
            due = [t0 + float(x) for x in self.due]
            self.bench.recorder.set_due(dict(zip(self.request_dirs, due)))
            proc.stdin.write(json.dumps({"bodies": bodies, "due": due}) + "\n")
            proc.stdin.flush()
            if profile is not None:
                time.sleep(max(0.0, t0 + seconds * self.mix["slice_start"] - time.perf_counter()))
                with profile(videos=None, requests=None, replays={}):
                    time.sleep(self.mix["slice_seconds"])
            results = json.loads(proc.stdout.readline())
        finally:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        out.attempted = count
        for i, rec in enumerate(results):
            if rec is None:
                out.failed += 1
                out.errors.append(f"request {i} never answered")
                continue
            ok, done, sent, err = rec
            out.late_s.append(sent - due[i])
            if ok:
                out.latencies_s.append(done - due[i])
                out.done_s.append(done - t0)
            else:
                out.failed += 1
                out.errors.append(err)
        out.videos_done = len(out.latencies_s)
        return out

    def close(self) -> None:
        from video_caption_tpu_torch.server.services import batching_queue
        from video_caption_tpu_torch.server.services.model_registry import MODEL_REGISTRY

        self.server.stop()
        self.queue.stop()
        with batching_queue._QUEUES_LOCK:
            batching_queue._QUEUES.pop(id(self.engine), None)
        MODEL_REGISTRY._engines.pop(self._key, None)


LOOPS = {"batch_pipelined": BatchPipelined, "open_poisson": OpenPoisson}


def make(bench, mix: dict) -> Loop:
    return LOOPS[mix["loop"]](bench, mix)
