"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level module names, and the reference imports nothing of the program."""
import ast
import subprocess
import sys
import types

import pytest

from caption_bench import harness

FORBIDDEN_FOR_REFERENCE = {"jax", "jaxlib", "flax", "video_caption_tpu",
                           "video_caption_tpu_torch"}


@pytest.mark.parametrize("name,flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("video_caption_tpu", True), ("video_caption_tpu.engine", True),
    ("video_caption_tpu_torch", False), ("video_caption_tpu_torch.engine", False),
    ("jaxtyping", False), ("flaxen", False), ("video_caption_tpux", False),
])
def test_forbidden_modules_compares_whole_top_level_names(monkeypatch, name, flagged):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in harness.forbidden_modules()) == flagged


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((harness.BENCH_DIR / "reference").glob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN_FOR_REFERENCE, f"{path.name} imports {name}"
            if top == "caption_bench":
                assert name.startswith("caption_bench.reference"), f"{path.name}: {name}"


def test_a_process_running_the_harness_and_the_port_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import caption_bench.harness, caption_bench.generator, caption_bench.control;"
            "import video_caption_tpu_torch.engine;"
            "import video_caption_tpu_torch.server.stdlib_server;"
            "import video_caption_tpu_torch.server.services.inference_service;"
            "from caption_bench.harness import forbidden_modules;"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_alone_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import caption_bench.reference.model, caption_bench.reference.judge;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'video_caption_tpu', 'video_caption_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
