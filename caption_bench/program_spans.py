"""The program's own spans inside a traced slice, for the ``program_span``
readers (``metrics/<name>.py``).

The port records spans at its layer boundaries while a torch profiler
session runs (``video_caption_tpu_torch/tracing.py``): the slice's profiler
is such a session, so the spans of the slice are in the process's buffer
after the window, on the clock of ``Slice.start``/``end``
(``time.perf_counter``; the spans' stamps are ``perf_counter_ns``). Every
reader returns None for another family, for no slice, or where the program
recorded no span in the slice (a program without ``tracing``)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple


def program_spans() -> list:
    """``tracing.spans()`` of the program, or nothing where it has none."""
    try:
        from video_caption_tpu_torch import tracing
    except ImportError:
        return []
    return tracing.spans()


def window(run, family: str) -> Optional[Tuple[list, int, int]]:
    """(the spans that overlap the slice, its start ns, its end ns), or
    None for another family, no slice or no span."""
    if run.family != family or run.slice is None:
        return None
    lo, hi = int(run.slice.start * 1e9), int(run.slice.end * 1e9)
    spans = [s for s in program_spans() if s.end > lo and s.start < hi]
    if not spans or hi <= lo:
        return None
    return spans, lo, hi


def _inside(s, lo: int, hi: int) -> bool:
    return lo <= s.start and s.end <= hi


def worker_busy(run, family: str) -> Optional[float]:
    """% of the slice the queue's worker (the thread of the ``queue.*``
    spans) spends outside ``queue.idle``; with several workers, the
    busiest."""
    w = window(run, family)
    if w is None:
        return None
    spans, lo, hi = w
    idle: Dict[int, int] = {s.thread: 0 for s in spans if s.name.startswith("queue.")}
    if not idle:
        return None
    for s in spans:
        if s.name == "queue.idle" and s.thread in idle:
            idle[s.thread] += min(s.end, hi) - max(s.start, lo)
    return max(100.0 * (1.0 - ns / (hi - lo)) for ns in idle.values())


def ms_per_frame(run, family: str, name: str) -> Optional[float]:
    """Summed milliseconds of the ``name`` spans that lie in the slice over
    the frames they decoded (their attr ``frames``)."""
    w = window(run, family)
    if w is None:
        return None
    spans, lo, hi = w
    hits = [s for s in spans if s.name == name and _inside(s, lo, hi)]
    frames = sum(s.attrs.get("frames", 0) for s in hits)
    if not frames:
        return None
    return sum(s.end - s.start for s in hits) / 1e6 / frames


def ms_per_dispatch(run, family: str, name: str) -> Optional[float]:
    """Summed milliseconds of the ``name`` spans under the ``engine.dispatch``
    spans that lie in the slice, over the number of those dispatches."""
    w = window(run, family)
    if w is None:
        return None
    spans, lo, hi = w
    dispatches = {s.id for s in spans if s.name == "engine.dispatch" and _inside(s, lo, hi)}
    if not dispatches:
        return None
    parent = {s.id: s.parent for s in spans}
    total = 0
    for s in spans:
        if s.name != name:
            continue
        up = s.parent
        while up is not None and up not in dispatches:
            up = parent.get(up)
        if up is not None:
            total += s.end - s.start
    return total / 1e6 / len(dispatches)

