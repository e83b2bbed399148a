"""engine.lookup_ms.batch: host milliseconds inside engine.lookup per engine.dispatch in the traced slice."""
from caption_bench import program_spans


def read(run):
    return program_spans.ms_per_dispatch(run, "batch", "engine.lookup")
