"""The port's serialized request artifact (aot.export_program,
aot.export_request_program, aot.AotRuntime) on the CPU, at the conftest's
tiny geometry in f32.

The artifact is the engine's request program exported with the weights,
the video and the sampled groups' Gumbel noise as inputs. Loaded in a fresh
process that imports only ``video_caption_tpu_torch.aot`` (which registers
the kernels' custom ops), its ids equal the live program's on the same
draws, the sampled group included; its beam groups equal the JAX package's
artifact on the same weights. A program that draws its noise inside (the
generator baked into the archive) does not follow the engine's generator."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_aot import _engine, _video, port_params  # noqa: F401
from video_caption_tpu.aot import AotRuntime as JaxAotRuntime
from video_caption_tpu.aot import export_request_program as jax_export_request_program
from video_caption_tpu.config import CompileConfig
from video_caption_tpu.config import default_inference_config as jax_default_config
from video_caption_tpu.engine import InferenceEngine as JaxEngine
from video_caption_tpu_torch import aot

REPO = Path(__file__).resolve().parents[1]

# the fresh process: the artifact, the inputs and the output path as arguments
FRESH_PROCESS = """
import sys
import torch
from video_caption_tpu_torch.aot import AotRuntime
artifact, inputs, out = sys.argv[1:4]
x = torch.load(inputs)
runtime = AotRuntime()
runtime.load("request", artifact)
ids = runtime.run("request", x["params"], x["video"], x["noises"])
torch.save({"ids": list(ids), "modules": sorted(m for m in sys.modules
            if m.split(".")[0] in ("jax", "video_caption_tpu", "video_caption_tpu_torch"))}, out)
"""


def _draw(engine):
    """The noise the engine's next request draws, the generator left where
    it was: the program's next call takes the same draws."""
    state = engine.generator.get_state()
    noises = engine.request_noise(1)
    engine.generator.set_state(state)
    return noises


@pytest.fixture(scope="module")
def exported(tiny_cfg, port_params, tmp_path_factory):  # noqa: F811
    """(engine, artifact path): the default presets' request program."""
    engine = _engine(tiny_cfg, port_params, seed=3)
    path = aot.export_request_program(engine, str(tmp_path_factory.mktemp("art") / "request.pt2"))
    return engine, path


@pytest.fixture(scope="module")
def fresh_process_run(exported, tmp_path_factory):
    """(live ids, the fresh process's ids and modules) for one video, after
    one request has moved the engine's generator on."""
    engine, path = exported
    program, _ = engine._fused_infer_program()
    video = _video(8)
    program(video)
    noises = _draw(engine)
    live = program(video)
    work = tmp_path_factory.mktemp("fresh")
    torch.save({"params": engine.params, "video": video, "noises": noises}, work / "inputs.pt")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", FRESH_PROCESS, path, str(work / "inputs.pt"),
                           str(work / "out.pt")], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return live, torch.load(work / "out.pt")


def test_export_program_round_trip(tmp_path):
    """The counterpart of tests/test_aot_alignment.py's round trip."""
    def fn(x, w):
        return torch.tanh(x @ w)

    x = torch.ones((2, 8))
    w = torch.full((8, 4), 0.5)
    path = aot.export_program(fn, (x, w), str(tmp_path / "fn.pt2"))
    rt = aot.AotRuntime()
    rt.load("fn", path)
    torch.testing.assert_close(rt.run("fn", x, w), fn(x, w), rtol=1e-6, atol=0)
    x2 = torch.linspace(-1, 1, 16).reshape(2, 8)
    torch.testing.assert_close(rt.run("fn", x2, w), fn(x2, w), rtol=1e-6, atol=0)


def test_aot_runtime_unknown_program():
    with pytest.raises(KeyError):
        aot.AotRuntime().run("nope", torch.ones(1))


def test_fresh_process_ids_equal_the_live_program(exported, fresh_process_run):
    """Every group's ids, the sampled one included, from the artifact loaded
    in a process that imported only the port's aot module (and so no engine
    and no JAX), equal the live program's on the same draws."""
    engine, _ = exported
    live, got = fresh_process_run
    _, groups = engine._fused_infer_program()
    assert [dp.num_beams for dp, *_ in groups] == [3, 1]       # a sampled group is there
    assert len(got["ids"]) == len(live)
    for a, b in zip(got["ids"], live):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert "video_caption_tpu_torch.aot" in got["modules"]
    assert not any(m.startswith(("jax", "video_caption_tpu.")) or m == "video_caption_tpu"
                   for m in got["modules"])
    assert "video_caption_tpu_torch.engine" not in got["modules"]


def test_artifact_stores_no_weights(exported):
    """The weights are inputs: the archive keeps no example inputs and, as
    constants, only the prompts' ids and masks and scalars."""
    _, path = exported
    program = torch.export.load(path)
    assert program.example_inputs is None
    assert not program.state_dict
    assert program.constants
    assert all(not t.is_floating_point() or t.dim() == 0 for t in program.constants.values())


def test_beam_groups_equal_the_jax_artifact(tiny_cfg, tiny_params, exported, tmp_path):
    """The port's artifact against the JAX package's ``export_request_program``
    run through its ``AotRuntime`` on the same weights and video: the beam
    groups exact (tests/test_aot_request_path.py pins the JAX artifact to
    its live program). The sampled group draws from two random streams."""
    engine, path = exported
    jcfg = jax_default_config(ckpt="missing.pt", num_frames=2, image_size=32,
                              compile=dataclasses.replace(CompileConfig(),
                                                          overlap_single_upload=False))
    jax_engine = JaxEngine(jcfg, params=tiny_params, model_cfg=tiny_cfg)
    jax_engine.tokenizer = engine.tokenizer
    jrt = JaxAotRuntime()
    jrt.load("request", jax_export_request_program(jax_engine, str(tmp_path / "request.shlo")))
    video = _video(7)
    want = jrt.run("request", jax_engine.params, jnp.asarray(video.numpy()),
                   jax.random.PRNGKey(0))
    rt = aot.AotRuntime()
    rt.load("request", path)
    got = rt.run("request", engine.params, video, _draw(engine))
    groups = engine._fused_infer_program()[1]
    beams = [i for i, (dp, *_) in enumerate(groups) if dp.num_beams > 1]
    assert beams
    for i in beams:
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))


def test_a_baked_draw_does_not_follow_the_engine(tiny_cfg, port_params, tmp_path):  # noqa: F811
    """The request program exported as it runs live, its generator inside:
    the archive keeps a copy of the generator, so once the engine has
    served a request the artifact's sampled ids are not the live
    program's, while the artifact of ``core`` given the same draws is.
    (A short sampled decode keeps the two exports quick.)"""
    engine = _engine(tiny_cfg, port_params, seed=3, preset1="natural", preset2="natural",
                     preset3="natural")
    engine._groups = [(dataclasses.replace(dp, max_new_tokens=4), *rest)
                      for dp, *rest in engine._decode_groups()]
    program, _ = engine._fused_infer_program()
    video = _video(8)
    rt = aot.AotRuntime()
    rt.load("baked", aot.export_program(program, (video,), str(tmp_path / "baked.pt2")))
    rt.load("core", aot.export_request_program(engine, str(tmp_path / "core.pt2")))
    program(video)
    noises = _draw(engine)
    (live,) = program(video)
    (core,) = rt.run("core", engine.params, video, noises)
    (baked,) = rt.run("baked", video)
    torch.testing.assert_close(core, live, rtol=0, atol=0)
    assert not torch.equal(baked, live)


def test_export_refuses_early_stop(tiny_cfg, port_params, tmp_path):  # noqa: F811
    """Early stop reads its condition on the host before every step: no
    fixed program, so no artifact (and no request graph)."""
    engine = _engine(tiny_cfg, port_params, early_stop_decode=True)
    with pytest.raises(ValueError, match="early_stop"):
        aot.export_request_program(engine, str(tmp_path / "request.pt2"))
