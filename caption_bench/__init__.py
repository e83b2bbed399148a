"""The benchmark of ``video_caption_tpu_torch`` on one NVIDIA H100.

``python3 caption_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. What
belongs to one configuration, traffic mix or per-layer metric lives in a
file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py``. The plain reference that decides ``correct`` is in
``reference/`` and imports nothing of the program.
"""
