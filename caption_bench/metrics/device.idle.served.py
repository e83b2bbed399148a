"""device.idle.served: % of the traced slice with no kernel on the device."""
from caption_bench import readers


def read(run):
    return readers.idle_share(run, "served")
