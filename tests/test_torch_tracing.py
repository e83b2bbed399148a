"""The port's spans and counters (``video_caption_tpu_torch/tracing.py``):
off with no profiler session, on under one entered on any thread, placed on
the profiler's clock; the coalescing queue's and the HTTP server's spans
over a stub engine; the engine's cache, frame and load spans on a tiny CPU
model. No JAX: the engine draws its own weights."""
import dataclasses
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from video_caption_tpu_torch import tracing
from video_caption_tpu_torch.config import default_inference_config
from video_caption_tpu_torch.engine import InferenceEngine
from video_caption_tpu_torch.models import caption_model as cm
from video_caption_tpu_torch.models import gpt2 as g2
from video_caption_tpu_torch.models import vit as vt
from video_caption_tpu_torch.server import stdlib_server
from video_caption_tpu_torch.server.services.batching_queue import BatchingQueue

NUM_FRAMES = 2


@pytest.fixture(autouse=True)
def _clean():
    tracing.reset()
    yield
    tracing.reset()


def _cpu_profile(**kw):
    return profile(activities=[ProfilerActivity.CPU], **kw)


def _by_name(name):
    return [s for s in tracing.spans() if s.name == name]


# ---- the switch ---------------------------------------------------------------


def test_the_switch_is_torchs_profiler_flag():
    """The one place a rename in torch shows: the flag ``enabled`` reads."""
    assert hasattr(autograd_profiler, "_is_profiler_enabled")
    assert tracing.enabled() is False
    with _cpu_profile():
        assert tracing.enabled() is True
    assert tracing.enabled() is False


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    entered = []

    class Counting(autograd_profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(autograd_profiler, "record_function", Counting)
    first = tracing.span("engine.dispatch", videos=8)
    assert first is tracing.NO_SPAN and tracing.request("server.request") is tracing.NO_SPAN
    with first, tracing.span("engine.lookup"):
        tracing.count("cache.hits", 3)
        tracing.annotate(rows=4)
    with tracing.waiting("queue.idle"):
        pass
    fut = object.__new__(type("Future", (), {}))
    tracing.stamp(fut)
    tracing.since("queue.wait", fut)
    tracing.record("queue.wait", 0, 1)
    assert tracing.requests_of([fut]) is None and not hasattr(fut, "_trace_stamp")
    assert tracing.spans() == [] and tracing.counters() == {} and entered == []
    # on, each span is a record_function
    with _cpu_profile():
        with tracing.span("engine.dispatch"):
            pass
    assert entered == ["engine.dispatch"]


# ---- on, from a session entered on another thread ------------------------------


def test_a_thread_started_before_the_session_records_while_it_runs():
    go, done = threading.Event(), threading.Event()
    seen = {}

    def worker():
        go.wait(10)
        with tracing.request("server.request") as outer:
            with tracing.span("engine.dispatch", videos=2) as inner:
                tracing.count("cache.hits", 2)
                tracing.annotate(rows=4)
        seen.update(outer=outer, inner=inner, ident=threading.get_ident())
        done.set()

    def session():
        with _cpu_profile():
            go.set()
            done.wait(10)

    t = threading.Thread(target=worker)
    t.start()                        # before any session
    s = threading.Thread(target=session)
    s.start()
    s.join(20)
    t.join(20)
    assert not s.is_alive() and not t.is_alive()
    inner, outer = tracing.spans()
    assert (inner.name, outer.name) == ("engine.dispatch", "server.request")
    assert inner is seen["inner"] and outer is seen["outer"]
    assert inner.parent == outer.id and outer.parent is None
    assert inner.thread == outer.thread == seen["ident"] != threading.get_ident()
    assert len(outer.requests) == 1 and inner.requests == outer.requests
    assert inner.counts == {"cache.hits": 2} and outer.counts == {}
    assert inner.attrs == {"videos": 2, "rows": 4}
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert tracing.counters() == {"cache.hits": 2}


def test_an_explicit_parent_crosses_threads_and_the_buffer_drops_the_oldest(monkeypatch):
    with _cpu_profile():
        with tracing.request("server.request") as top:
            box = []
            t = threading.Thread(target=lambda: box.append(
                tracing.span("engine.frame_decode", parent=top, frames=2).__enter__()))
            t.start()
            t.join(10)
            box[0].__exit__(None, None, None)
    decode, request = tracing.spans()
    assert decode.parent == request.id and decode.requests == request.requests
    assert decode.thread != request.thread and decode.attrs == {"frames": 2}
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    monkeypatch.setattr(tracing, "_buffer", __import__("collections").deque(maxlen=3))
    with _cpu_profile():
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
    assert [s.name for s in tracing.spans()] == ["s2", "s3", "s4"] and tracing.dropped() == 2


def test_a_wait_is_kept_where_the_session_ran_at_either_end():
    release = threading.Event()

    def wait():
        with tracing.waiting("queue.idle"):
            release.wait(10)

    t = threading.Thread(target=wait)
    t.start()                        # begins with no session
    time.sleep(0.05)
    with _cpu_profile():
        release.set()
        t.join(10)
    (idle,) = tracing.spans()
    assert idle.name == "queue.idle" and idle.end - idle.start >= 40e6


def test_unix_ns_lands_on_the_profilers_clock():
    from torch._C._profiler import _ExperimentalConfig

    box = []

    def worker():
        with tracing.span("engine.replay") as s:
            time.sleep(0.002)
        box.append(s)

    with _cpu_profile(experimental_config=_ExperimentalConfig(profile_all_threads=True)) as p:
        t = threading.Thread(target=worker)
        t.start()
        t.join(10)
    (ours,) = box
    base = p.profiler.kineto_results.trace_start_ns()
    (event,) = [e for e in p.events() if e.name == "engine.replay"]
    kineto_ns = base + event.time_range.start * 1e3
    assert abs(tracing.unix_ns(ours.start) - kineto_ns) < 2e6


# ---- the queue and the server ---------------------------------------------------


class StubEngine:
    def __init__(self, fail=False):
        self.fail = fail

    def infer_batch_dispatch(self, dirs):
        if self.fail:
            raise FileNotFoundError("boom")
        return list(dirs)

    def infer_batch_collect(self, dirs):
        return [f"res:{d}" for d in dirs]

    def infer(self, d):
        return f"one:{d}"


def _three_through_a_queue(engine):
    q = BatchingQueue(engine, max_batch=3, max_wait_ms=5000)
    try:
        with _cpu_profile():
            futs = [q.submit(f"dir{i}") for i in range(3)]
            results = [f.result(timeout=10) for f in futs]
    finally:
        q.stop()
    return results


def test_the_queue_spans_one_coalesced_batch():
    assert _three_through_a_queue(StubEngine()) == ["res:dir0", "res:dir1", "res:dir2"]
    waits = _by_name("queue.wait")
    ids = [w.requests for w in waits]
    assert len(waits) == 3 and all(len(r) == 1 for r in ids) and len(set(ids)) == 3
    (coalesce,) = _by_name("queue.coalesce")
    assert coalesce.attrs == {"videos": 3, "rows": 4}
    (dispatch,) = _by_name("queue.dispatch")
    (resolve,) = _by_name("queue.resolve")
    assert dispatch.requests == resolve.requests == tuple(r for (r,) in ids)
    assert {w.thread for w in waits} == {coalesce.thread, dispatch.thread}
    assert tracing.counters() == {"queue.batches": 1, "queue.videos": 3,
                                  "queue.padding_rows": 1}


def test_a_failed_dispatch_counts_its_requests_retried_one_by_one():
    assert _three_through_a_queue(StubEngine(fail=True)) == ["one:dir0", "one:dir1",
                                                             "one:dir2"]
    assert tracing.counters()["queue.fallback_requests"] == 3


def test_the_servers_request_id_reaches_the_queue(monkeypatch):
    q = BatchingQueue(StubEngine(), max_batch=1, max_wait_ms=1)
    monkeypatch.setattr(stdlib_server, "_infer_payload",
                        lambda body: {"caption": q.infer(body["frames_dir"])})
    srv = stdlib_server.StdlibServer("127.0.0.1", 0).start()
    try:
        with _cpu_profile():
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/api/v1/infer",
                data=json.dumps({"frames_dir": "d"}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                assert json.loads(resp.read()) == {"caption": "res:d"}
    finally:
        srv.stop()
        q.stop()
    (request,) = _by_name("server.request")
    (wait,) = _by_name("queue.wait")
    (dispatch,) = _by_name("queue.dispatch")
    assert len(request.requests) == 1
    assert wait.requests == dispatch.requests == request.requests
    assert request.start <= wait.start <= wait.end <= request.end


# ---- the engine -------------------------------------------------------------------


class WordTok:
    eos_token_id = bos_token_id = pad_token_id = 127
    vocab_size = 128

    def encode(self, text):
        return [b % 127 for b in text.encode()] or [1]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{int(i)}" for i in ids if int(i) != 127)


@pytest.fixture(scope="module")
def engine():
    mc = cm.CaptionModelConfig(
        vit=vt.ViTConfig(image_size=32, patch_size=16, embed_dim=32, depth=1, num_heads=2,
                         out_dim=16, dtype=torch.float32),
        gpt2=g2.GPT2Config(vocab_size=128, max_position_embeddings=64, n_embd=32, n_layer=1,
                           n_head=2, dtype=torch.float32),
        prefix_len=2, video_dim=16)
    cfg = default_inference_config(ckpt="missing.pt", num_frames=NUM_FRAMES, image_size=32)
    eng = InferenceEngine(cfg, model_cfg=dataclasses.replace(mc), seed=0, device="cpu")
    eng.tokenizer = WordTok()
    return eng


def _dir(root, name, seed):
    d = root / name
    d.mkdir()
    rng = np.random.RandomState(seed)
    for i in range(NUM_FRAMES + 1):
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(d / f"frame_{i:05d}.jpg")
    return str(d)


def test_the_engine_counts_cache_misses_then_hits_and_frames_by_path(engine, tmp_path,
                                                                    monkeypatch):
    # the switch alone: a session would record every op of the decode
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)
    dirs = [_dir(tmp_path, f"v{i}", i) for i in range(2)]
    engine.infer_batch(dirs)
    first = tracing.counters()
    frames = sum(n for k, n in first.items() if k.startswith("frames."))
    assert first["cache.misses"] == 2 and "cache.hits" not in first
    assert frames == 2 * NUM_FRAMES
    (load,) = _by_name("engine.load")
    decodes = _by_name("engine.frame_decode")
    assert len(decodes) == 2 and all(d.parent == load.id for d in decodes)
    assert all(d.attrs == {"frames": NUM_FRAMES} for d in decodes)
    assert sum(n for d in decodes for k, n in d.counts.items() if k.startswith("frames.")) \
        == frames
    (dispatch,) = _by_name("engine.dispatch")
    (lookup,) = _by_name("engine.lookup")
    (replay,) = _by_name("engine.replay")
    assert {load.parent, lookup.parent, replay.parent} == {dispatch.id}
    assert lookup.counts == {"cache.misses": 2}
    (collect,) = _by_name("engine.collect")
    (detok,) = _by_name("engine.detokenize")
    assert detok.parent == collect.id
    tracing.reset()
    engine.infer_batch(dirs)
    again = tracing.counters()
    assert again["cache.hits"] == 2 and "cache.misses" not in again
    assert not any(k.startswith("frames.") for k in again)
    assert _by_name("engine.load") == [] and len(_by_name("engine.lookup")) == 1
