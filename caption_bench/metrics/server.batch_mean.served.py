"""server.batch_mean.served: Real videos (padding rows not counted) a queue dispatch carried, mean over the window."""
from caption_bench import readers


def read(run):
    return readers.batch_mean(run, "served")
