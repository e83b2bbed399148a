"""engine.dispatch_ms.batch: Host milliseconds of one infer_batch_dispatch call (load, upload, enqueue), mean over the window."""
from caption_bench import readers


def read(run):
    return readers.dispatch_ms_mean(run, "batch")
