"""server.queue_wait_ms_p95.served: 95th percentile (nearest rank) of the time from a request's due time to the entry of the dispatch that carries it."""
from caption_bench import readers


def read(run):
    return readers.queue_wait_p95(run, "served")
