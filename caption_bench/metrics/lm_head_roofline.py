"""lm_head_roofline: lm_head's bound time over its kernels' device time in the traced slice, %."""
from caption_bench import readers


def read(run):
    return readers.roofline(run, "batch", "lm_head_stats", "lm_head_row_stats_kernel")
