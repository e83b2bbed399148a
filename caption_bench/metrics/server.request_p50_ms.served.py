"""server.request_p50_ms.served: median latency of the requests answered before the traced slice, each from its due time."""
from caption_bench import readers


def read(run):
    return readers.latency_p50(run, "served")
