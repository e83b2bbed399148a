"""server.worker_busy.served: % of the traced slice the queue's worker spends outside queue.idle (the program's spans)."""
from caption_bench import program_spans


def read(run):
    return program_spans.worker_busy(run, "served")
