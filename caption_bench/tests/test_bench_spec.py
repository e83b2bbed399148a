"""BENCHMARK.json against the benchmark's contract, and the harness finding
every configuration, traffic mix and per-layer metric by name."""
import json
import re
import shutil

import pytest

from caption_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["caption_bench"]
    assert SPEC["command"][1] == "caption_bench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("caption_bench/") and c["reduced"] == []
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_its_files_by_name(workload):
    cell = harness.resolve(SPEC, workload)
    assert cell.config["name"] == cell.config_name
    assert harness.traffic_path(cell.traffic_name).is_file()
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in names, "a per-layer metric's cells report what it moves"
        assert callable(harness.load_reader(m["name"]))


def test_every_metric_file_is_named_in_the_benchmark():
    named = {m["name"] for m in SPEC["per_layer"]}
    files = {p.name[:-3] for p in (harness.BENCH_DIR / "metrics").glob("*.py")}
    assert files == named


def test_a_new_cell_is_found_from_new_files_and_entries_alone(tmp_path):
    """A later PR adds a traffic mix, a per-layer metric and a cell as new
    files and entries, and edits no file that is there."""
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(harness.BENCH_DIR / sub, tmp_path / "caption_bench" / sub)
    mix = json.loads(harness.traffic_path("b8_warm").read_text())
    mix.update(batch=4, pool=32)
    (tmp_path / "caption_bench" / "traffic" / "b4_warm.json").write_text(json.dumps(mix))
    (tmp_path / "caption_bench" / "metrics" / "server.batches.batch.py").write_text(
        "def read(run):\n    return 42.0\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "core.b4.warm", "config": "vitb16_gpt2_core",
                              "traffic": "b4_warm", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "core.b8.warm" in m.get("workloads", []):
            m["workloads"].append("core.b4.warm")
    spec["per_layer"].append({"name": "server.batches.batch", "unit": "batches",
                              "better": "higher", "source": "program_counter",
                              "layer": "server", "moves": "captions_per_s",
                              "workloads": ["core.b4.warm"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.resolve(harness.load_spec(tmp_path), "core.b4.warm", root=tmp_path)
    assert cell.mix["batch"] == 4
    assert "server.batches.batch" in {m["name"] for m in cell.per_layer}
    assert harness.load_reader("server.batches.batch", root=tmp_path)(None) == 42.0


def test_configuration_files_state_the_published_widths():
    for c in SPEC["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["vit"] == {"image_size": 224, "patch_size": 16, "in_chans": 3,
                              "embed_dim": 768, "depth": 12, "num_heads": 12, "mlp_ratio": 4,
                              "out_dim": 256}
        g = cfg["gpt2"]
        assert (g["n_embd"], g["n_layer"], g["n_head"], g["vocab_size"]) == (768, 12, 12, 50257)
        assert cfg["reduced"] == [] and cfg["num_frames"] == 16 and cfg["dtype"] == "bfloat16"


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_has_a_limit(workload):
    cell = harness.resolve(SPEC, workload)
    assert 0 < cell.mix["limits"]["mean_gap"] < 1e-3
