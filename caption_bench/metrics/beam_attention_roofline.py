"""beam_attention_roofline: beam_attention's bound time over its kernel's device time in the traced slice, %."""
from caption_bench import readers


def read(run):
    return readers.roofline(run, "batch", "beam_attention", "beam_attention_kernel")
