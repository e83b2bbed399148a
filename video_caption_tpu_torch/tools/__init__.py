"""Batch and checkpoint tooling of the port (counterpart of
video_caption_tpu/tools/): in-process batch inference and its best-of
filter, checkpoint export, the stage-by-stage debugger, and the closed
quality loop that trains and scores the first checkpoint."""
