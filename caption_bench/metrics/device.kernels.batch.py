"""device.kernels.batch: Device kernels in the traced slice per video completed."""
from caption_bench import readers


def read(run):
    return readers.kernels_per_video(run, "batch")
