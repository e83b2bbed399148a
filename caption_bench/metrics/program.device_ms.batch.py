"""program.device_ms.batch: Summed kernel milliseconds in the traced slice per video completed."""
from caption_bench import readers


def read(run):
    return readers.device_ms_per_video(run, "batch")
