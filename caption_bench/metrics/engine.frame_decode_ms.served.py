"""engine.frame_decode_ms.served: summed engine.frame_decode milliseconds in the traced slice over the frames those spans decoded."""
from caption_bench import program_spans


def read(run):
    return program_spans.ms_per_frame(run, "served", "engine.frame_decode")
