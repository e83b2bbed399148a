"""Device admission gate (counterpart of
video_caption_tpu/server/services/task_manager.py).

Serializes device work when batch serving is off: by default one request is
on the device at a time, so latency stays predictable under load and
out-of-memory failures cannot stack.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager


class DeviceTaskManager:
    def __init__(self, max_concurrent_tasks: int = 1):
        self._sem = threading.Semaphore(max_concurrent_tasks)
        self.max_concurrent_tasks = max_concurrent_tasks

    @contextmanager
    def acquire(self):
        self._sem.acquire()
        try:
            yield
        finally:
            self._sem.release()


DEVICE_TASK_MANAGER = DeviceTaskManager(max_concurrent_tasks=1)
