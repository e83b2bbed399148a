"""Measurement stack of the port (counterpart of video_caption_tpu/bench/
and the root bench.py): the stage benchmark and its report files, the
profiler capture, the three probes, the roofline against the H100's peaks,
the serving load sweep, the peaked-logit accuracy gate and the throughput
driver. Reports go to reports/torch/ by default."""
