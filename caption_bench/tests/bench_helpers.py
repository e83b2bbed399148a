"""Shared by the benchmark's CPU tests: a configuration of
``caption_bench/configs`` at the tiny CPU size of ``<config>_tiny.json``
beside this file, under a traffic mix of ``caption_bench/traffic``, cut to
what a CPU test run holds."""
import json
from pathlib import Path

from caption_bench import harness

HERE = Path(__file__).resolve().parent

KINDS = {
    "batch_warm": ("vitb16_gpt2_core", "b8_warm", dict(pool=16, judged=4)),
    "served": ("vitb16_gpt2_serving", "open_poisson",
               dict(pool=4, judged=12, rate_per_s=6.0, warmup_seconds=1.0)),
}
"""One cell of each loop the generator has."""


def tiny_cell(kind: str) -> harness.Cell:
    config_name, traffic, cut = KINDS[kind]
    config = json.loads((HERE / f"{config_name}_tiny.json").read_text())
    mix = json.loads(harness.traffic_path(traffic).read_text())
    mix.update(cut)
    mix["limits"] = {"mean_gap": 1e-6}      # float32 on both sides reads 0
    return harness.Cell(kind, config_name, config, traffic, mix, 1, [], [])
