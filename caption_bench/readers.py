"""The arithmetic the per-layer readers share (``metrics/<name>.py`` each
call one of these with its family). Every reader returns None where the
run has nothing for it to read: another family, no traced slice, no
published peak for the card, or no call of the kernel in the slice."""
from __future__ import annotations

import statistics
from typing import Optional

from caption_bench import stats


def _slice(run, family: str):
    return run.slice if run.family == family and run.slice is not None else None


def _complete_slice(run, family: str):
    """The slice, where its trace holds every kernel launch counted in it:
    kernel counts, kernel time and idle time are read from no other."""
    s = _slice(run, family)
    return s if s is not None and s.complete else None


def idle_share(run, family: str) -> Optional[float]:
    """% of the slice's wall time with no kernel running on the device."""
    s = _complete_slice(run, family)
    if s is None or s.wall_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.wall_s)


def mfu(run, family: str) -> Optional[float]:
    """% of the bf16 peak: model FLOPs of the videos completed in the slice
    over its wall time."""
    s = _slice(run, family)
    if s is None or run.peaks is None or not s.videos or s.wall_s <= 0:
        return None
    return 100.0 * s.model_flops / s.wall_s / run.peaks["bf16_flops"]


def device_ms_per_video(run, family: str) -> Optional[float]:
    """Summed kernel milliseconds in the slice per video completed."""
    s = _complete_slice(run, family)
    if s is None or not s.videos:
        return None
    return 1e3 * s.kernel_s / s.videos


def kernels_per_video(run, family: str) -> Optional[float]:
    s = _complete_slice(run, family)
    if s is None or not s.videos:
        return None
    return s.kernels / s.videos


def roofline(run, family: str, op: str, counted_kernel: str) -> Optional[float]:
    """% of the bound: the op's bound over its kernels' summed device time
    in the slice. The bound of one program run comes from its calls
    (``Readings.op_bounds``); the slice holds ``replays`` runs, and
    ``counted_kernel`` launches once a call. Where the trace holds fewer
    of its launches than the runs made (the profiler drops events under a
    dense trace), the bound is taken for the launches it holds, at the run's
    mean bound a call."""
    s = _slice(run, family)
    if s is None or not run.op_bounds or op not in run.op_bounds or run.batch is None:
        return None
    calls, bound_s = run.op_bounds[op]
    expected = calls * s.replays.get(run.batch, 0)
    launched = s.by_port_kernel.get(counted_kernel, (0, 0.0))[0]
    _, seconds = s.op_seconds(op)
    if not expected or not launched or seconds <= 0 or launched > expected:
        return None
    return 100.0 * bound_s / calls * launched / seconds


def dispatch_ms_mean(run, family: str) -> Optional[float]:
    """Mean host milliseconds of an ``infer_batch_dispatch`` call over the
    window."""
    if run.family != family or not run.outcome.dispatch_ms:
        return None
    return statistics.fmean(run.outcome.dispatch_ms)


def batch_mean(run, family: str) -> Optional[float]:
    """Mean real videos a queue dispatch carried over the window."""
    if run.family != family or not run.dispatch_videos:
        return None
    return statistics.fmean(run.dispatch_videos)


def queue_wait_p95(run, family: str) -> Optional[float]:
    if run.family != family or not run.queue_wait_ms:
        return None
    return stats.percentile(run.queue_wait_ms, 95)


def latency_p50(run, family: str) -> Optional[float]:
    """Median latency, from the due time, of the requests answered before
    the slice (profiling stalls the live load while it starts and stops)."""
    if run.family != family or not run.latency_ms:
        return None
    return statistics.median(run.latency_ms)
