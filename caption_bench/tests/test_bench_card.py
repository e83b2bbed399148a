"""On the card: one short run of each cell through the command line, as
the benchmark's check runs it, 8 s long: enough for every cell's judged
sample (``python -m pytest caption_bench/tests -q -m cuda`` on a machine
with an H100)."""
import json
import subprocess
import sys

import pytest
import torch

from caption_bench import harness

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_is_correct(card, workload):
    out = subprocess.run([sys.executable, "caption_bench/run.py", "--workload", workload,
                          "--seed", str(2 ** 31 + 101), "--seconds", "8", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("the machine has a card")
    out = subprocess.run([sys.executable, "caption_bench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
