"""Data preparation & maintenance scripts of the port (counterpart of
video_caption_tpu/scripts/; reference: scripts/): MSVD and MSR-VTT
preparation, multiprocess frame extraction, annotation repair, coverage
checks, result plotting. Host code, the JAX package's own."""
