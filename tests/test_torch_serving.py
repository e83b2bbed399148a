"""The port's serving path on the CPU, at the conftest's tiny geometry in f32:
``infer_batch`` and its dispatch/collect halves, the device video cache, the
coalescing batch queue, the stdlib HTTP server and its schemas, the engine
registry and ``cli/serve.py``; each held against the JAX package where it has
a counterpart (the cases of tests/test_video_cache.py,
tests/test_batching_queue.py and tests/test_server.py)."""
import ast
import dataclasses
import inspect
import json
import os
import textwrap
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_aot import WordTok, _engine, port_params  # noqa: F401
from video_caption_tpu.config import default_inference_config as jax_default_config
from video_caption_tpu.engine import InferenceEngine as JaxEngine
from video_caption_tpu.server import schemas as jschemas
from video_caption_tpu.server.services import batching_queue as jqueue
from video_caption_tpu.server.services import task_manager as jtasks
from video_caption_tpu_torch.config import default_inference_config, serving_inference_config
from video_caption_tpu_torch.decode import unified
from video_caption_tpu_torch.engine import InferenceEngine
from video_caption_tpu_torch.preprocessing import frame_loader
from video_caption_tpu_torch.server import schemas
from video_caption_tpu_torch.server.services import batching_queue, model_registry, task_manager
from video_caption_tpu_torch.server.services.batching_queue import BatchingQueue

BEAM_PRESETS = dict(preset1="precise", preset2="detailed", preset3="precise",
                    prompt3="Another prompt:")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Many small ops: under several test workers, torch's intra-op thread
    pools would oversubscribe the cores (results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(root, name, n=2, seed=0):
    d = root / name
    d.mkdir()
    rng = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(d / f"frame_{i:05d}.jpg")
    return str(d)


@pytest.fixture(scope="module")
def frames_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("serving")
    return [_frames(root, f"v{v}", n, seed=30 + v) for v, n in enumerate((3, 2, 5))]


@pytest.fixture()
def engine(tiny_cfg, port_params):  # noqa: F811
    """All presets ``precise`` (one beam group), as tests/test_video_cache.py."""
    return _engine(tiny_cfg, port_params, preset1="precise", preset2="precise",
                   preset3="precise")


def _api(results):
    return [r.to_api_dict() for r in results]


# ---- batches -------------------------------------------------------------


def test_infer_batch_equals_the_jax_infer_batch(tiny_cfg, tiny_params, port_params,  # noqa: F811
                                                frames_dirs):
    """Beam presets in two policy groups, three dirs: the same results."""
    jax_engine = JaxEngine(jax_default_config(ckpt="missing.pt", num_frames=2, image_size=32,
                                              **BEAM_PRESETS), params=tiny_params,
                           model_cfg=tiny_cfg)
    jax_engine.tokenizer = WordTok()
    port = _engine(tiny_cfg, port_params, **BEAM_PRESETS)
    got = _api(port.infer_batch(frames_dirs))
    assert got == _api(jax_engine.infer_batch(frames_dirs))
    assert len({r["S1"] for r in got}) > 1             # not vacuous


def test_each_row_of_infer_batch_equals_infer(engine, frames_dirs):
    batch = _api(engine.infer_batch(frames_dirs))
    assert batch == [engine.infer(d).to_api_dict() for d in frames_dirs]


def test_dispatch_twice_then_collect_in_order(engine, frames_dirs):
    """The queue's double buffer: batch N+1 dispatched before batch N is
    collected gives what each batch gives alone (beam presets: a row does
    not depend on its batch)."""
    first = engine.infer_batch_dispatch(frames_dirs[:2])
    second = engine.infer_batch_dispatch(frames_dirs[1:])
    assert first.done is None and first.ids.shape == second.ids.shape   # CPU: no event
    got = _api(engine.infer_batch_collect(first)) + _api(engine.infer_batch_collect(second))
    alone = _api(engine.infer_batch(frames_dirs))
    assert got == alone[:2] + alone[1:]


def test_batch_program_is_grouped_unless_unified_decode(tiny_cfg, port_params,  # noqa: F811
                                                        frames_dirs, monkeypatch):
    """A batch of V > 1 runs the grouped batch program by default and the
    unified loop under ``unified_decode``; both give the same results on
    beam presets (the same seed for the sampled one is not shared here)."""
    calls = []
    real = unified.generate_unified
    monkeypatch.setattr(unified, "generate_unified",
                        lambda *a, **k: (calls.append(a[2].shape[0]), real(*a, **k))[1])
    grouped = _api(_engine(tiny_cfg, port_params, **BEAM_PRESETS).infer_batch(frames_dirs[:2]))
    assert calls == []
    uni = _api(_engine(tiny_cfg, port_params, unified_decode=True,
                       **BEAM_PRESETS).infer_batch(frames_dirs[:2]))
    assert calls == [2] and uni == grouped


def test_generate_once_equals_the_engines_beam_caption(engine, frames_dirs):
    from video_caption_tpu_torch.decode.presets import preset_to_kwargs

    prefix = engine.compute_prefix(engine.load_video(frames_dirs[2]))
    got = engine.generate_once(prefix, engine.config.prompt2, **preset_to_kwargs("precise"))
    assert got == engine.infer(frames_dirs[2]).candidates.s2


def test_from_config_builds_on_the_card(monkeypatch):
    """from_config is InferenceEngine(config): the card, no CPU default (here,
    with no card, it raises before loading anything)."""
    loads = []
    monkeypatch.setattr("video_caption_tpu_torch.engine.load_params",
                        lambda *a, **k: loads.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine.from_config(default_inference_config(ckpt="missing.pt"))
    assert loads == []


# ---- the video cache -------------------------------------------------------


def _count_loads(monkeypatch):
    calls = []
    real = frame_loader.load_video_packed
    monkeypatch.setattr(frame_loader, "load_video_packed",
                        lambda *a, **k: (calls.append(a), real(*a, **k))[1])
    return calls


def test_repeat_dir_hits_cache(engine, tmp_path, monkeypatch):
    d = _frames(tmp_path, "v0")
    calls = _count_loads(monkeypatch)
    r1 = engine.infer_batch([d, d])
    assert len(calls) == 1
    r2 = engine.infer_batch([d, d])
    assert len(calls) == 1, "an unchanged dir must be served from the cache"
    assert _api(r1) == _api(r2)


def test_duplicate_dirs_in_one_batch_load_once(engine, tmp_path, monkeypatch):
    d = _frames(tmp_path, "v1", seed=1)
    calls = _count_loads(monkeypatch)
    results = engine.infer_batch([d, d, d, d])
    assert len(calls) == 1, "duplicate dirs in one batch must decode once"
    assert len({json.dumps(r) for r in _api(results)}) == 1


def test_mtime_change_invalidates(engine, tmp_path):
    d = _frames(tmp_path, "v2", seed=2)
    key1, _ = engine._video_cache_get(d)
    engine.infer(d)
    _, hit = engine._video_cache_get(d)
    assert hit is not None
    time.sleep(0.02)
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(os.path.join(d, "frame_00001.jpg"))
    key2, hit2 = engine._video_cache_get(d)
    assert key2 != key1 and hit2 is None


def test_non_newest_frame_replacement_invalidates(engine, tmp_path):
    """Replacing a frame that is not the newest (a timestamp-preserving copy
    keeps the dir's newest mtime) still misses: the key digests every file."""
    d = _frames(tmp_path, "v2b", seed=7)
    os.utime(os.path.join(d, "frame_00001.jpg"), ns=(2**62, 2**62))
    engine.infer(d)
    assert engine._video_cache_get(d)[1] is not None
    Image.fromarray(np.full((32, 32, 3), 7, np.uint8)).save(os.path.join(d, "frame_00000.jpg"))
    os.utime(os.path.join(d, "frame_00000.jpg"), ns=(1000, 1000))
    assert engine._video_cache_get(d)[1] is None


def test_capacity_eviction(engine, tmp_path):
    engine._video_cache_bytes = 8000       # one [1,2,3,32,32] uint8 video: 6144 bytes
    a = _frames(tmp_path, "va", seed=3)
    b = _frames(tmp_path, "vb", seed=4)
    engine.infer(a)
    engine.infer(b)
    assert engine._video_cache_get(b)[1] is not None
    assert engine._video_cache_get(a)[1] is None, "the LRU must evict the older video"
    assert engine._video_cache_total == 6144


def test_cache_disabled(engine, tmp_path, monkeypatch):
    engine._video_cache_bytes = 0
    d = _frames(tmp_path, "v3", seed=5)
    engine.infer(d)
    assert len(engine._video_cache) == 0
    monkeypatch.setenv("VIDEO_CAPTION_VIDEO_CACHE_MB", "0")
    assert InferenceEngine(engine.config, params=engine.params, model_cfg=engine.model_cfg,
                           device="cpu")._video_cache_bytes == 0


def test_missing_and_non_directory_paths_raise_file_not_found(engine, tmp_path):
    """A missing path, a path that is a file and an empty directory raise
    FileNotFoundError (the server answers 400), through every entry point;
    the JAX key lets the non-directory's NotADirectoryError through."""
    good = _frames(tmp_path, "ok")
    not_a_dir = os.path.join(good, "frame_00000.jpg")
    empty = tmp_path / "empty"
    empty.mkdir()
    for path in (str(tmp_path / "absent"), not_a_dir, str(empty)):
        with pytest.raises(FileNotFoundError):
            engine._video_cache_key(path)
        with pytest.raises(FileNotFoundError):
            engine.infer(path)
        with pytest.raises(FileNotFoundError):
            engine.infer_batch([good, path])


# ---- the batching queue ----------------------------------------------------


class RecordingEngine:
    """Engine stub recording batch sizes (dispatch/collect API)."""

    def __init__(self, fail_on=None):
        self.batches = []
        self.fail_on = fail_on or set()

    def infer_batch_dispatch(self, dirs):
        self.batches.append(len(dirs))
        return list(dirs)

    def infer_batch_collect(self, dirs):
        if any(d in self.fail_on for d in dirs):
            raise FileNotFoundError("boom")
        return [f"res:{d}" for d in dirs]

    def infer(self, d):
        if d in self.fail_on:
            raise FileNotFoundError(f"missing {d}")
        return f"res:{d}"


def test_queue_coalesces_concurrent_requests():
    eng = RecordingEngine()
    q = BatchingQueue(eng, max_batch=8, max_wait_ms=100)
    futs = [q.submit(f"dir{i}") for i in range(6)]
    assert [f.result(timeout=10) for f in futs] == [f"res:dir{i}" for i in range(6)]
    q.stop()
    assert max(eng.batches) > 1 and all(b in (1, 2, 4, 8) for b in eng.batches)


def test_queue_isolates_errors_per_request():
    eng = RecordingEngine(fail_on={"bad"})
    q = BatchingQueue(eng, max_batch=8, max_wait_ms=100)
    good, bad = q.submit("good"), q.submit("bad")
    assert good.result(timeout=10) == "res:good"
    with pytest.raises(FileNotFoundError):
        bad.result(timeout=10)
    q.stop()


def test_queue_and_task_manager_are_the_jax_packages():
    """The copies run the JAX package's code: every function's syntax tree,
    docstrings left out, is the original's."""
    def body(obj):
        fn = obj.__func__ if isinstance(obj, staticmethod) else obj
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.body \
                    and isinstance(node.body[0], ast.Expr) \
                    and isinstance(node.body[0].value, ast.Constant):
                node.body = node.body[1:]
        return ast.dump(tree)

    for port, ref in ((batching_queue.BatchingQueue, jqueue.BatchingQueue),
                      (task_manager.DeviceTaskManager, jtasks.DeviceTaskManager)):
        for name, member in vars(ref).items():
            if callable(member) or isinstance(member, staticmethod):
                assert body(vars(port)[name]) == body(member), name
    assert body(batching_queue.get_queue) == body(jqueue.get_queue)


def test_real_engine_behind_the_queue(engine, frames_dirs):
    engine.warmup()
    want = {d: engine.infer(d).to_api_dict() for d in frames_dirs}
    q = BatchingQueue(engine, max_batch=4, max_wait_ms=200)
    results = {}
    threads = [threading.Thread(target=lambda d=d: results.__setitem__(d, q.infer(d)))
               for d in frames_dirs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    q.stop()
    assert not any(t.is_alive() for t in threads)
    assert {d: r.to_api_dict() for d, r in results.items()} == want


# ---- the HTTP server -------------------------------------------------------


@pytest.fixture(scope="module")
def server(tiny_cfg, port_params):  # noqa: F811
    from video_caption_tpu_torch.server.stdlib_server import StdlibServer

    engine = _engine(tiny_cfg, port_params)
    model_registry.MODEL_REGISTRY.get_engine = lambda config: engine
    srv = StdlibServer("127.0.0.1", 0).start()
    yield srv
    del model_registry.MODEL_REGISTRY.get_engine
    srv.stop()


def _call(port, path, payload=None, raw=None):
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_health(server):
    for path in ("/health", "/api/v1/health", "/", "/api/v1"):
        assert _call(server.port, path) == (200, {"status": "ok"})


def test_infer_both_mounts(server, frames_dirs):
    for path in ("/infer", "/api/v1/infer"):
        status, body = _call(server.port, path, {"frames_dir": frames_dirs[0]})
        assert status == 200, body
        assert set(body) == {"S1", "S2", "S3", "BEST"} and set(body["BEST"]) == {"key", "text"}


def test_infer_missing_dir_is_400(server):
    status, body = _call(server.port, "/infer", {"frames_dir": "/no/such/dir"})
    assert status == 400 and "frames_dir" in body["detail"]


@pytest.mark.parametrize("payload", [{"wrong_field": 1}, {"frames_dir": 3},
                                     {"frames_dir": "/x", "num_frames": "many"}, [1, 2]])
def test_infer_bad_payload_is_422(server, payload):
    assert _call(server.port, "/infer", payload)[0] == 422


def test_unknown_route_404(server):
    assert _call(server.port, "/nope", {})[0] == 404
    assert _call(server.port, "/nope")[0] == 404


def test_cuda_era_fields_accepted(server, frames_dirs):
    status, body = _call(server.port, "/infer", {
        "frames_dir": frames_dirs[1], "device": "cuda", "vit_enable_torch_compile": True,
        "use_cupy_prefix_projector": False, "vit_torch_compile_mode": "max-autotune"})
    assert status == 200, body


def test_status_codes_equal_the_jax_servers(tiny_cfg, tiny_params, port_params,  # noqa: F811
                                            frames_dirs, monkeypatch):
    """Every route and payload gets the JAX stdlib server's status code."""
    from video_caption_tpu.server.services import model_registry as jregistry
    from video_caption_tpu.server.stdlib_server import StdlibServer as JaxServer
    from video_caption_tpu_torch.server.stdlib_server import StdlibServer

    jax_engine = JaxEngine(jax_default_config(ckpt="missing.pt", num_frames=2, image_size=32),
                           params=tiny_params, model_cfg=tiny_cfg)
    jax_engine.tokenizer = WordTok()
    port = _engine(tiny_cfg, port_params)
    monkeypatch.setattr(jregistry.MODEL_REGISTRY, "get_engine", lambda config: jax_engine)
    monkeypatch.setattr(model_registry.MODEL_REGISTRY, "get_engine", lambda config: port)
    servers = [JaxServer("127.0.0.1", 0).start(), StdlibServer("127.0.0.1", 0).start()]
    cases = [("/health", None, None), ("/api/v1/health", None, None), ("/missing", None, None),
             ("/infer", {"frames_dir": frames_dirs[0]}, None),
             ("/api/v1/infer", {"frames_dir": frames_dirs[0], "device": "cuda"}, None),
             ("/infer", {"frames_dir": "/no/such/dir"}, None),
             ("/infer", {"wrong_field": 1}, None), ("/infer", None, b"not json"),
             ("/infer", {"frames_dir": frames_dirs[0], "num_frames": 2.5}, None),
             ("/nope", {"frames_dir": frames_dirs[0]}, None)]
    try:
        codes = [[_call(s.port, path, payload, raw)[0] for s in servers]
                 for path, payload, raw in cases]
    finally:
        for s in servers:
            s.stop()
    assert all(j == p for j, p in codes), codes
    assert [c[1] for c in codes] == [200, 200, 404, 200, 200, 400, 422, 422, 422, 404]


def test_schema_fields_and_defaults_equal_the_jax_models():
    ref = jschemas.InferRequest.model_fields
    port = {f.name: f for f in dataclasses.fields(schemas.InferRequest)}
    assert set(port) == set(ref)
    for name, field in ref.items():
        default = None if field.is_required() else field.default
        port_default = port[name].default
        assert (port_default is dataclasses.MISSING) == field.is_required(), name
        if not field.is_required():
            assert port_default == default, name


@pytest.mark.parametrize("payload", [
    {"frames_dir": "/x"}, {"frames_dir": "/x", "num_frames": "16"},
    {"frames_dir": "/x", "num_frames": 16.0}, {"frames_dir": "/x", "num_frames": 2.5},
    {"frames_dir": "/x", "ln_scale": 1}, {"frames_dir": "/x", "ln_scale": "0.5"},
    {"frames_dir": "/x", "use_pallas_fused_pool": "yes"},
    {"frames_dir": "/x", "use_pallas_fused_pool": "maybe"},
    {"frames_dir": "/x", "use_pallas_fused_pool": 1}, {"frames_dir": "/x", "device": None},
    {"frames_dir": "/x", "device": 3}, {"frames_dir": 3}, {"frames_dir": "/x", "extra": 1},
    {"prompt1": "a"},
])
def test_schema_accepts_and_refuses_what_pydantic_does(payload):
    try:
        want = jschemas.InferRequest(**payload).model_dump()
    except ValueError:
        want = None
    if want is None:
        with pytest.raises((ValueError, TypeError)):
            schemas.InferRequest.from_payload(payload)
    else:
        got = dataclasses.asdict(schemas.InferRequest.from_payload(payload))
        assert got == want
        assert all(type(got[k]) is type(want[k]) for k in want)


def test_warmup_config_matches_request_path_engine():
    """``cli/serve.py --warmup`` warms the engine the request path builds for
    default fields (the registry keys engines by the whole config)."""
    from video_caption_tpu_torch.server.services.inference_service import request_to_config

    req_cfg = request_to_config(schemas.InferRequest(frames_dir="/tmp/x"))
    assert serving_inference_config().cache_key() == req_cfg.cache_key()


def test_registry_builds_one_engine_per_config_on_its_device(monkeypatch):
    built = []

    class Stub:
        def __init__(self, config, device):
            built.append((config.cache_key(), device))

    monkeypatch.setattr(model_registry, "InferenceEngine", Stub)
    assert model_registry.MODEL_REGISTRY.device == "cuda"
    reg = model_registry.ModelRegistry(device="cpu")
    a, b = serving_inference_config(), serving_inference_config(num_frames=16)
    assert reg.get_engine(a) is reg.get_engine(a) and reg.get_engine(b) is not reg.get_engine(a)
    assert built == [(a.cache_key(), "cpu"), (b.cache_key(), "cpu")] and len(reg) == 2
    reg.clear()
    assert len(reg) == 0


def test_serve_cli_warms_the_serving_engine_then_serves(monkeypatch):
    from video_caption_tpu_torch.cli import serve
    from video_caption_tpu_torch.server import stdlib_server

    events = []

    class Eng:
        def warmup(self):
            events.append("warmup")
            return 1.5

    monkeypatch.setattr(model_registry.MODEL_REGISTRY, "get_engine",
                        lambda config: events.append(config.cache_key()) or Eng())
    monkeypatch.setattr(stdlib_server.StdlibServer, "serve_forever",
                        lambda self: (events.append((self.host, self.port)),
                                      self.httpd.server_close()))
    assert serve.main(["--host", "127.0.0.1", "--port", "0", "--warmup"]) == 0
    assert events[:2] == [serving_inference_config().cache_key(), "warmup"]
    assert events[2][0] == "127.0.0.1" and events[2][1] > 0
