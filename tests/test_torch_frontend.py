"""The port's frontend (frontend/api_client.py, frontend/chainlit_app.py)
against the port's stdlib server on 127.0.0.1 with a tiny engine on the CPU:
the round trip through httpx and through urllib, ``BackendError`` wrapping,
``check_health``, the chat handler's replies, and the JAX package's client
against the same server returning the same dicts."""
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_aot import _engine, port_params  # noqa: F401
from video_caption_tpu.frontend import api_client as japi
from video_caption_tpu.frontend import chainlit_app as japp
from video_caption_tpu_torch.frontend import api_client, chainlit_app
from video_caption_tpu_torch.server.services import model_registry


@pytest.fixture(scope="module")
def frames_dirs(tmp_path_factory):
    rng = np.random.RandomState(23)
    dirs = []
    for v, n in enumerate((2, 3)):
        d = tmp_path_factory.mktemp(f"front{v}")
        for i in range(n):
            Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(d / f"frame_{i:05d}.jpg")
        dirs.append(str(d))
    return dirs


@pytest.fixture(scope="module")
def server(tiny_cfg, port_params):  # noqa: F811
    """All presets beams (``precise``), so that repeated requests give the
    same captions."""
    from video_caption_tpu_torch.server.stdlib_server import StdlibServer

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    engine = _engine(tiny_cfg, port_params, preset1="precise", preset2="precise",
                     preset3="precise")
    model_registry.MODEL_REGISTRY.get_engine = lambda config: engine
    srv = StdlibServer("127.0.0.1", 0).start()
    yield srv
    del model_registry.MODEL_REGISTRY.get_engine
    srv.stop()
    torch.set_num_threads(threads)


@pytest.fixture()
def backend(server, monkeypatch):
    url = f"http://127.0.0.1:{server.port}"
    monkeypatch.setattr(api_client, "BACKEND_URL", url)
    monkeypatch.setattr(japi, "BACKEND_URL", url)
    return url


@pytest.fixture(params=["httpx", "urllib"])
def transport(request, monkeypatch):
    if request.param == "httpx":
        pytest.importorskip("httpx")
    else:
        monkeypatch.setitem(sys.modules, "httpx", None)     # import httpx raises ImportError
    return request.param


def _closed_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_round_trip_equals_the_jax_clients(backend, transport, frames_dirs):
    for d in frames_dirs:
        got = api_client.infer_caption(d)
        assert got == japi.infer_caption(d)
        assert set(got) == {"S1", "S2", "S3", "BEST"} and set(got["BEST"]) == {"key", "text"}
        assert got["BEST"]["text"] == got[got["BEST"]["key"]]
    overrides = {"num_frames": 2, "preset2": "detailed"}
    assert api_client.infer_caption(frames_dirs[0], **overrides) == \
        japi.infer_caption(frames_dirs[0], **overrides)


@pytest.mark.parametrize("payload,code", [({"frames_dir": "/no/such/dir"}, 400),
                                          ({"frames_dir": "/x", "num_frames": "many"}, 422)])
def test_backend_errors_are_wrapped(backend, transport, payload, code):
    payload = dict(payload)
    frames_dir = payload.pop("frames_dir")
    with pytest.raises(api_client.BackendError) as port_err:
        api_client.infer_caption(frames_dir, **payload)
    with pytest.raises(japi.BackendError) as jax_err:
        japi.infer_caption(frames_dir, **payload)
    assert str(port_err.value) == str(jax_err.value)
    assert str(port_err.value).startswith(f"backend error {code}: ")


def test_unreachable_backend_through_urllib(monkeypatch):
    monkeypatch.setitem(sys.modules, "httpx", None)
    url = f"http://127.0.0.1:{_closed_port()}"
    monkeypatch.setattr(api_client, "BACKEND_URL", url)
    with pytest.raises(api_client.BackendError, match="backend unreachable at"):
        api_client.infer_caption("/tmp")
    assert api_client.check_health() is False


def test_check_health(backend, monkeypatch):
    assert api_client.check_health() is True and japi.check_health() is True
    monkeypatch.setattr(api_client, "BACKEND_URL", f"http://127.0.0.1:{_closed_port()}")
    assert api_client.check_health() is False


def test_handle_message_replies_as_the_jax_app(backend, frames_dirs, tmp_path):
    reply = chainlit_app.handle_message(f' "{frames_dirs[1]}" ')
    assert reply == japp.handle_message(f' "{frames_dirs[1]}" ')
    body = api_client.infer_caption(frames_dirs[1])
    assert reply == chainlit_app.format_result(body)
    assert reply.startswith(f"**BEST ({body['BEST']['key']}):** ")
    missing = str(tmp_path / "missing")
    for text in ("", "   ", missing):
        assert chainlit_app.handle_message(text) == japp.handle_message(text)
    assert "is not a directory" in chainlit_app.handle_message(missing)


def test_handle_message_reports_a_failing_backend(monkeypatch, frames_dirs):
    monkeypatch.setitem(sys.modules, "httpx", None)
    monkeypatch.setattr(api_client, "BACKEND_URL", f"http://127.0.0.1:{_closed_port()}")
    assert chainlit_app.handle_message(frames_dirs[0]).startswith(
        "Inference failed: backend unreachable at")


def test_backend_url_is_read_at_import():
    import os
    import subprocess
    from pathlib import Path

    code = ("import sys, video_caption_tpu_torch.frontend.chainlit_app as app\n"
            "from video_caption_tpu_torch.frontend import api_client\n"
            "print(api_client.BACKEND_URL)\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')]\n")
    env = {**os.environ, "VIDEO_CAPTION_BACKEND_URL": "http://127.0.0.1:9"}
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         env=env, capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "http://127.0.0.1:9"
    assert chainlit_app.cl is None or hasattr(chainlit_app, "on_message")
