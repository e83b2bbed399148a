"""The port's measurement stack (video_caption_tpu_torch/bench/, env.py,
memory.py, cli/check_env.py) on the CPU, at the conftest's tiny geometry in
f32, held against the JAX package's bench/ where it has a counterpart:
the report files byte for byte, the roofline's analytic FLOPs and bytes,
its stage names, StageBench's greedy tokens and row keys, the serving
sweep's knee decisions and the driver's pipelined credit."""
import csv
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_aot import WordTok, port_cfg, port_params  # noqa: F401
from video_caption_tpu.bench import benchmark as jbenchmark
from video_caption_tpu.bench import report as jreport
from video_caption_tpu.bench import roofline as jroofline
from video_caption_tpu.bench import serving_load as jserving
from video_caption_tpu.config import default_inference_config as jax_default_config
from video_caption_tpu.decode.generate import DecodeParams as JaxDecodeParams
from video_caption_tpu.engine import InferenceEngine as JaxEngine
from video_caption_tpu.memory import is_oom_error as jax_is_oom_error
from video_caption_tpu.models import caption_model as jcm
from video_caption_tpu_torch import env, memory
from video_caption_tpu_torch.bench import benchmark, driver, profile, report, roofline, serving_load
from video_caption_tpu_torch.cli import check_env
from video_caption_tpu_torch.config import default_inference_config
from video_caption_tpu_torch.decode.generate import DecodeParams
from video_caption_tpu_torch.engine import InferenceEngine
from video_caption_tpu_torch.models import gpt2 as g2
from video_caption_tpu_torch.models import vit as vt
from video_caption_tpu_torch.models.convert import params_from_jax_numpy
from video_caption_tpu_torch.server.services import batching_queue, model_registry


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Many small ops: under several test workers, torch's intra-op thread
    pools would oversubscribe the cores (results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench_frames")
    rng = np.random.RandomState(7)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(d / f"frame_{i:05d}.jpg")
    return str(d)


def _port_engine(tiny_cfg, params, **overrides):
    engine = InferenceEngine(default_inference_config(ckpt="missing.pt", num_frames=2,
                                                      image_size=32, **overrides),
                             params=params, model_cfg=port_cfg(tiny_cfg), device="cpu")
    engine.tokenizer = WordTok()
    return engine


# ---- report.py -------------------------------------------------------------

ROWS = [{"iteration": i, "preprocess_ms": 1.5 + i, "vit_ms": 2.25 * i, "gpt2_ms": 10.0 / 3,
         "batch_size": 1, "dtype": "bfloat16", "caption_preview": f"a man, {i}"} for i in range(3)]
BS_ROWS = [{"batch_size": 1, "status": "ok", "end_to_end_mean_ms": 12.5, "throughput_std": 0.1},
           {"batch_size": 16, "status": "OOM"}]


def _write_reports(rpt, out, writer):
    if writer == "iterations":
        rpt.write_iteration_csv(out / "baseline_iterations.csv", ROWS)
    elif writer == "bs_comparison":
        rpt.write_bs_comparison(out / "benchmark_bs_comparison.csv", BS_ROWS)
    else:
        summary = rpt.build_summary(
            {"end_to_end": [10.0, 12.0, 11.0], "vit": [5.0, 6.0, 5.5], "gpt2_token_step": []},
            throughput=[0.1, 0.09, 0.095], env={"backend": "cpu"},
            config={"batch_size": 2, "iters": 3}, generated_tokens=[10, 12, 11],
            caption_preview="a man", peak_memory_mb={"vit": 12.5})
        rpt.write_json(out / "baseline_summary.json", summary)


@pytest.mark.parametrize("writer", ["iterations", "bs_comparison", "summary"])
def test_report_files_are_byte_identical(tmp_path, writer):
    for name, rpt in (("port", report), ("jax", jreport)):
        (tmp_path / name).mkdir()
        _write_reports(rpt, tmp_path / name, writer)
    (path,) = list((tmp_path / "port").iterdir())
    assert path.read_bytes() == (tmp_path / "jax" / path.name).read_bytes()


# ---- roofline.py: analytic FLOPs and bytes ---------------------------------


@pytest.fixture(scope="module")
def full_geometry():
    """ViT-B/16 + GPT-2: (JAX config, the shapes of the JAX init, port
    config, the port's own init of the encoder and decoder on the meta
    device: shapes and dtypes, no values)."""
    jcfg = jcm.CaptionModelConfig()
    jparams = jax.eval_shape(lambda: jcm.init_caption_model(jax.random.PRNGKey(0), jcfg))
    pcfg = port_cfg(jcfg)
    return jcfg, jparams, pcfg, {"encoder": vt.init_vit_params(None, pcfg.vit, "meta"),
                                 "decoder": g2.init_gpt2_params(None, pcfg.gpt2, "meta")}


def _groups(dp_cls, ids_of):
    """Two policy groups as the engines list them: (policy, preset indices,
    prompt ids, prompt mask)."""
    return [(dp_cls(max_new_tokens=24, num_beams=3), (0, 1), ids_of((2, 44)), ids_of((2, 44))),
            (dp_cls(max_new_tokens=40, num_beams=1, temperature=0.7), (2,), ids_of((1, 30)),
             ids_of((1, 30)))]


ANALYTIC = {
    "vit_encode_flops": lambda m, c, p: m.vit_encode_flops(c, 16),
    "vit_encode_bytes": lambda m, c, p: m.vit_encode_bytes(p, c, 16, 2),
    "gpt2_step_flops": lambda m, c, p: m.gpt2_step_flops(c.gpt2, 40),
    "decode_group_flops": lambda m, c, p: m.decode_group_flops(c.gpt2, 2, 3, 48, 24, 72),
    "decode_group_bytes": lambda m, c, p: m.decode_group_bytes(p, c.gpt2, 2, 3, 24, 72),
    "training_step_flops": lambda m, c, p: m.training_step_flops(c, 4, 8, 24, 2),
}


@pytest.mark.parametrize("which", ["tiny", "full"])
@pytest.mark.parametrize("name", sorted(ANALYTIC) + ["decode_unified_cost"])
def test_analytic_cost_equals_the_jax_packages(tiny_cfg, tiny_params, port_params,  # noqa: F811
                                               request, which, name):
    jcfg, jparams, pcfg, pparams = (
        (tiny_cfg, tiny_params, port_cfg(tiny_cfg), port_params) if which == "tiny"
        else request.getfixturevalue("full_geometry"))
    if name == "decode_unified_cost":
        got = roofline.decode_unified_cost(pparams, pcfg.gpt2, _groups(
            DecodeParams, lambda s: torch.zeros(s, dtype=torch.int64)), 2, pcfg.prefix_len)
        want = jroofline.decode_unified_cost(jparams, jcfg.gpt2, _groups(
            JaxDecodeParams, lambda s: np.zeros(s, np.int32)), 2, jcfg.prefix_len)
    else:
        got, want = (ANALYTIC[name](roofline, pcfg, pparams),),\
            (ANALYTIC[name](jroofline, jcfg, jparams),)
    for g, w in zip(got, want):
        assert g > 0
        assert g == pytest.approx(w, rel=1e-9)


# ---- roofline.py: measurement ----------------------------------------------


def test_chip_peaks_none_on_cpu():
    assert roofline.chip_peaks() is None
    assert roofline.chip_peaks("cpu") is None
    assert roofline.PEAK_DEVICES == ("NVIDIA H100 80GB HBM3",)


def test_measure_roofline_stage_names_equal_the_jax_packages(tiny_cfg, tiny_params,  # noqa: F811
                                                             port_params, tmp_path):
    jax_engine = JaxEngine(jax_default_config(ckpt="missing.pt", num_frames=2, image_size=32),
                           params=tiny_params, model_cfg=tiny_cfg)
    want = jroofline.measure_roofline(jax_engine, batch=2, trials=1, report_path=None,
                                      amortize=1)
    engine = _port_engine(tiny_cfg, port_params)
    seed_state = engine.generator.get_state()
    path = tmp_path / "roofline.json"
    got = roofline.measure_roofline(engine, batch=2, trials=2, report_path=str(path), amortize=2)
    names = [s["stage"] for s in got["stages"]]
    assert names == [s["stage"] for s in want["stages"]]
    assert names[-1] == "decode[grouped,pipelined]"
    assert set(got) == set(want) and got["device_kind"] == "cpu" and got["peaks"] is None
    for stage in got["stages"]:
        assert set(stage) == {"stage", "device_ms", "gflops", "gbytes", "tflops_per_sec",
                              "gbytes_per_sec"}
        assert all(v > 0 for k, v in stage.items() if k != "stage")
    assert got["device_total_ms"] > 0 and got["device_caps_per_sec"] > 0
    assert json.loads(path.read_text())["stages"] == got["stages"]
    # throwaway generators: the engine's draws are untouched
    assert torch.equal(engine.generator.get_state(), seed_state)


def test_measure_roofline_unified_stage(tiny_cfg, port_params):  # noqa: F811
    """With the batches' unified decode the groups' loop is one stage, and
    the device total is the encode plus it."""
    compile_cfg = dataclasses.replace(default_inference_config().compile, unified_decode=True)
    engine = _port_engine(tiny_cfg, port_params, compile=compile_cfg)
    got = roofline.measure_roofline(engine, batch=1, trials=1, report_path=None, amortize=1)
    stages = {s["stage"]: s for s in got["stages"]}
    assert list(stages)[-1] == "decode[unified]" and "decode[grouped,pipelined]" not in stages
    assert got["device_total_ms"] == pytest.approx(
        stages["encode"]["device_ms"] + stages["decode[unified]"]["device_ms"])


def test_measure_training_step_on_cpu(tiny_cfg, tmp_path):
    path = tmp_path / "train.json"
    got = roofline.measure_training_step(batch=2, num_frames=2, trials=2, device="cpu",
                                         model_cfg=port_cfg(tiny_cfg), report_path=str(path))
    assert got["xla_cost_gflops"] is None and got["device_kind"] == "cpu"
    assert "pct_peak_flops" not in got and got["yuv420_wire"] is False
    for key in ("device_ms", "e2e_ms", "e2e_prefetch_ms", "gflops", "tflops_per_sec"):
        assert got[key] > 0, key
    assert got["gflops"] == pytest.approx(
        roofline.training_step_flops(port_cfg(tiny_cfg), 2, 2, 24) / 1e9)
    assert json.loads(path.read_text()) == got
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        roofline.measure_training_step(yuv420_wire=True, device="cpu")


# ---- benchmark.py ----------------------------------------------------------


def test_stage_bench_greedy_tokens_equal_the_jax_stage_bench(tiny_cfg, tiny_params, frames_dir,
                                                             monkeypatch):
    """The tiny model with its position table scaled by 10, so that the
    greedy tokens vary along the row; the same weights in both packages."""
    jparams = {**tiny_params, "decoder": {**tiny_params["decoder"],
                                          "wpe": tiny_params["decoder"]["wpe"] * 10}}
    port_weights = params_from_jax_numpy(jax.tree.map(np.asarray, jparams), port_cfg(tiny_cfg),
                                         "cpu")
    monkeypatch.setattr(jbenchmark, "load_params", lambda config, mc: jparams)
    monkeypatch.setattr(jbenchmark, "model_config_from_inference", lambda config: tiny_cfg)
    jcfg = jax_default_config(ckpt="missing.pt", num_frames=2, image_size=32)
    jax_bench = jbenchmark.StageBench(jcfg, batch_size=2, max_new_tokens=6)
    jax_bench.tokenizer = WordTok()
    tokens = []
    prefill, step = jax_bench.prefill_fn, jax_bench.decode_step_fn

    def prefill_spy(params, prefix):
        out = prefill(params, prefix)
        tokens.append(np.asarray(jnp.argmax(out[0], axis=-1)))
        return out

    def step_spy(*args):
        out = step(*args)
        tokens.append(np.asarray(out[0]))
        return out

    jax_bench.prefill_fn, jax_bench.decode_step_fn = prefill_spy, step_spy
    want_row = jax_bench.run_iteration(frames_dir)

    bench = benchmark.StageBench(default_inference_config(ckpt="missing.pt", num_frames=2,
                                                          image_size=32),
                                 batch_size=2, max_new_tokens=6, params=port_weights,
                                 model_cfg=port_cfg(tiny_cfg), device="cpu")
    bench.tokenizer = WordTok()
    rows = [bench.run_iteration(frames_dir) for _ in range(2)]
    np.testing.assert_array_equal(bench.last_ids, np.stack(tokens, axis=1))
    assert len(set(bench.last_ids.ravel().tolist())) > 1          # not vacuous
    for row in rows:
        assert set(row) == set(want_row)
        assert row["caption_preview"] == want_row["caption_preview"]
        assert row["generated_tokens"] == want_row["generated_tokens"]
        assert row["gpt2_token_step_ms"] > 0 and row["peak_memory_mb"] == ""


def test_run_sweep_writes_the_report_files_and_stops_at_oom(tiny_cfg, port_params,  # noqa: F811
                                                            frames_dir, tmp_path, monkeypatch):
    from video_caption_tpu_torch import engine as engine_mod

    monkeypatch.setattr(engine_mod, "get_tokenizer", WordTok)
    real = benchmark.benchmark_one_batch_size

    def one(config, frames, bs, *args, **kw):
        if bs == 4:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
        return real(config, frames, bs, *args, **kw)

    monkeypatch.setattr(benchmark, "benchmark_one_batch_size", one)
    cfg = default_inference_config(ckpt="missing.pt", num_frames=2, image_size=32)
    summary = benchmark.run_sweep(cfg, frames_dir, [1, 2, 4, 8], 1, 2, 4, tmp_path, tag="fp32",
                                  params=port_params, model_cfg=port_cfg(tiny_cfg), device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "baseline_iterations_fp32.csv", "baseline_summary_fp32.json",
        "benchmark_bs_comparison_fp32.csv", "benchmark_bs_summary_fp32.json"]
    with (tmp_path / "benchmark_bs_comparison_fp32.csv").open() as fh:
        rows = list(csv.DictReader(fh))
    assert [(r["batch_size"], r["status"]) for r in rows] == [("1", "ok"), ("2", "ok"),
                                                               ("4", "OOM")]
    with (tmp_path / "baseline_iterations_fp32.csv").open() as fh:
        assert next(csv.reader(fh)) == jreport.ITERATION_COLUMNS
    assert set(summary) == set(json.loads((tmp_path / "baseline_summary_fp32.json").read_text()))
    assert summary["environment"]["backend"] == "cpu"
    assert summary["End_to_end_Latency"]["mean"] > 0


def test_profile_once_writes_its_trace_and_stages(tiny_cfg, port_params, frames_dir,  # noqa: F811
                                                  tmp_path, monkeypatch):
    from video_caption_tpu_torch import engine as engine_mod

    monkeypatch.setattr(engine_mod, "get_tokenizer", WordTok)
    monkeypatch.setattr(profile, "default_inference_config",
                        lambda num_frames: default_inference_config(
                            ckpt="missing.pt", num_frames=num_frames, image_size=32))
    meta = profile.run_one_profile(frames_dir, tmp_path, warmup=1, num_frames=2,
                                   max_new_tokens=4, device="cpu", params=port_params,
                                   model_cfg=port_cfg(tiny_cfg))
    saved = json.loads((tmp_path / "profile_once.json").read_text())
    assert saved == meta and set(meta) == {"stages_ms", "trace_dir", "profile_wall_s",
                                           "environment"}
    trace = json.loads((tmp_path / "torch_trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"Inference_Once", "Preprocessing", "ViT_Encoder", "Cross_Modal_Alignment",
            "GPT2_Decoder_Step"} <= names


# ---- serving_load.py -------------------------------------------------------


class _FakeServer:
    def stop(self):
        pass


def _fake_curve(capacity):
    """run_load / _boot_server stand-ins: the server keeps up to
    ``capacity`` QPS, with p99 rising with the load."""

    class Config:
        preset1, preset2, preset3 = "precise", "detailed", "natural"

    def boot(frames_dir, num_frames=16, max_batch=8, port=0):
        return Config(), _FakeServer(), "http://127.0.0.1:0/api/v1/infer", b"{}"

    def run_load(frames_dir, qps, duration_s, port=0, num_frames=16, max_batch=8, _booted=None):
        achieved = min(qps, capacity)
        return {"offered_qps": qps, "achieved_qps": achieved, "send_window_qps": achieved,
                "errors": 0, "workload_presets": ["precise", "detailed", "natural"],
                "latency_ms": {"p50": 50.0 + qps, "p99": 100.0 + 10 * qps}}

    return boot, run_load


@pytest.mark.parametrize("capacity", [30.0, 100.0, 1000.0])
def test_run_sweep_decisions_equal_the_jax_packages(monkeypatch, capacity):
    """Knee by achieved QPS (30), by climbing past the ladder (100), by the
    p99 gate (1000: p99 passes 2000 ms above 190 QPS)."""
    from video_caption_tpu.server.services import model_registry as jregistry

    results = []
    for mod, registry in ((serving_load, model_registry), (jserving, jregistry)):
        boot, load = _fake_curve(capacity)
        monkeypatch.setattr(mod, "_boot_server", boot)
        monkeypatch.setattr(mod, "run_load", load)
        monkeypatch.setattr(registry.MODEL_REGISTRY, "clear", lambda: None)
        results.append(mod.run_sweep("/frames", duration_s=1.0, num_frames=2))
    got, want = results
    assert got == want
    assert got["knee_found"] and got["max_sustainable_qps"] > 0
    assert got["cache_off_at_max"]["offered_qps"] == got["max_sustainable_qps"]


def test_run_load_over_the_stdlib_server(tiny_cfg, port_params, frames_dir,  # noqa: F811
                                         monkeypatch):
    engine = _port_engine(tiny_cfg, port_params)
    monkeypatch.setattr(model_registry.MODEL_REGISTRY, "get_engine", lambda config: engine)
    monkeypatch.setenv("VIDEO_CAPTION_SERVE_MAX_BATCH", "8")
    try:
        result = serving_load.run_load(frames_dir, qps=20, duration_s=1.5, num_frames=2,
                                       max_batch=4)
    finally:
        batching_queue.get_queue(engine).stop()
    assert result["errors"] == 0 and result["error_samples"] == []
    assert result["requests_ok"] == result["requests_sent"] >= 10
    assert result["latency_ms"]["p50"] is not None and result["server"] == "stdlib_server"


# ---- driver.py -------------------------------------------------------------


def test_pipelined_throughput_credits_only_the_timed_batches(tiny_cfg, port_params,  # noqa: F811
                                                             frames_dir, monkeypatch):
    """A fake clock that advances 1 s per collect: the clock starts at the
    first collect and the n credited batches take n s, so batch * n / n
    captions/s; crediting the first collect or the drain would change it."""
    engine = _port_engine(tiny_cfg, port_params)
    clock, log = [0.0], []
    dispatch, collect = engine.infer_batch_dispatch, engine.infer_batch_collect

    def timed_collect(handle):
        clock[0] += 1.0
        log.append("c")
        return collect(handle)

    monkeypatch.setattr(engine, "infer_batch_dispatch",
                        lambda dirs: (log.append("d"), dispatch(dirs))[1])
    monkeypatch.setattr(engine, "infer_batch_collect", timed_collect)
    monkeypatch.setattr(driver.time, "perf_counter", lambda: clock[0])
    got = driver.pipelined_throughput(engine, [frames_dir] * 3, batch=2, n_batches=3, depth=2)
    assert got == 2.0
    assert log == ["d", "d"] + ["d", "c"] * 4 + ["c", "c"]


def test_driver_main_needs_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(["0", "1", "1"])


# ---- memory.py, env.py, cli/check_env.py -----------------------------------


def test_memory_manager_on_cpu():
    snap = memory.MemoryManager(device="cpu").snapshot()
    assert (snap.bytes_in_use, snap.bytes_limit, snap.peak_bytes_in_use, snap.bytes_reserved,
            snap.mb_in_use) == (None,) * 5
    with pytest.raises(RuntimeError, match="no CUDA device"):
        memory.MemoryManager()
    mm = memory.MemoryManager(device="cpu")
    with pytest.raises(torch.cuda.OutOfMemoryError):
        with mm.oom_guard():
            raise torch.cuda.OutOfMemoryError("Tried to allocate 2.00 GiB")


@pytest.mark.parametrize("err", [RuntimeError("RESOURCE_EXHAUSTED: hbm"),
                                 RuntimeError("CUDA out of memory. Tried to allocate"),
                                 RuntimeError("Out of memory while allocating"),
                                 ValueError("shape mismatch")])
def test_is_oom_error_agrees_with_the_jax_package(err):
    assert memory.is_oom_error(err) == jax_is_oom_error(err)


def test_is_oom_error_knows_the_cuda_error():
    assert memory.is_oom_error(torch.cuda.OutOfMemoryError("allocator"))


def test_env_on_cpu():
    info = env.device_summary()
    assert info["backend"] == "cpu" and info["device_kind"] == "cpu"
    assert info["torch_version"] == torch.__version__ and info["nvidia_smi"] is None
    env.assert_core_runtime_ready()
    env.assert_server_runtime_ready()
    with pytest.raises(env.RuntimeNotReady, match="GPU"):
        env.assert_core_runtime_ready(require_gpu=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark.StageBench(default_inference_config(), 1)


@pytest.mark.parametrize("argv,rc", [([], 0), (["--require-gpu"], 1)])
def test_check_env(capsys, argv, rc):
    assert check_env.main(argv) == rc
    out = capsys.readouterr().out
    assert "[ok] import video_caption_tpu_torch.bench.benchmark" in out
    assert "backend=cpu" in out and ("[FAIL]" in out) == bool(rc)
