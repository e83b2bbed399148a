"""mfu.served: Model FLOPs of the videos whose batch completed in the traced slice over its seconds, as a % of the bf16 peak."""
from caption_bench import readers


def read(run):
    return readers.mfu(run, "served")
