"""The traced slice: ``torch.profiler`` (CPU and CUDA activity) over a
bounded part of the window, reduced to what the per-layer readers need, and
the log of the program's kernel calls by op.

- ``Slice``: device busy seconds (the union of kernel intervals), kernel
  count and summed kernel seconds, seconds by kernel name and by the port's
  kernel (named as ``video_caption_tpu_torch/cli/profile_request.py``'s
  ``port_kernel`` names them: the function of ``ops/csrc/*.cu`` in its
  anonymous namespace), the ten largest device operations and the ten
  largest idle gaps by the innermost host event open at the gap's middle
  (the benchmark's own spans, ``bench.*``, among them). The profiler can
  drop kernel events; ``complete`` says whether the trace holds every
  launch the port's kernel wrappers counted in the slice (their
  ``launches``, which a graph replay keeps up to date), and the readers of
  kernel counts, kernel time and idle time read only a complete slice.
- ``OpLog``: a dispatch mode that records every ``torch.ops.vct.*`` call
  with its cost (``flops.COSTS``) while one program runs eagerly.
"""
from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from caption_bench import flops

_ANON = "(anonymous namespace)::"


def port_kernel(name: str, kernels) -> Optional[str]:
    """The function name of a kernel of ``ops/csrc/*.cu`` (one of
    ``kernels``), or None."""
    rest = name.removeprefix("void ")
    if not rest.startswith(_ANON):
        return None
    ident = re.match(r"\w+", rest[len(_ANON):])
    return ident.group(0) if ident is not None and ident.group(0) in kernels else None


SPAN_PREFIX = "bench."
"""The benchmark's own spans (``record_function``) begin with this."""

SHORT_GAP_US = 20.0
"""Idle gaps shorter than this are summed as one entry, not attributed."""

KERNEL_OPS = {"lm_head_stats": "lm_head_", "beam_attention": "beam_attention_kernel"}
"""Op -> the prefix of the port kernels one call of it launches."""

ONCE_A_CALL = {
    "encoder_attention": ("attention_bf16_kernel", "attention_f32_kernel"),
    "prefix_projector": ("prefix_projector_kernel",),
    "lm_head": ("lm_head_row_stats_kernel",),
    "beam_attention": ("beam_attention_kernel",),
    "decode_attention": ("decode_attention_kernel",),
    "decode_layer": ("decode_layer_kernel",),
    "fused_pool": ("fused_pool_kernel",),
}
"""Kernel wrapper (``ops/<name>.py``) -> the kernels of which one call
launches exactly one."""


@dataclass
class Slice:
    wall_s: float
    busy_s: float
    kernels: int
    kernel_s: float
    by_name: Dict[str, Tuple[int, float]]
    by_port_kernel: Dict[str, Tuple[int, float]]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    start: float = 0.0
    """Host clock (``time.perf_counter``) when the profiler started."""
    end: float = 0.0
    videos: int = 0
    requests: int = 0
    model_flops: float = 0.0
    replays: Dict[int, int] = field(default_factory=dict)
    """Program runs in the slice, by videos a run."""
    launches: Dict[str, int] = field(default_factory=dict)
    """Calls of each kernel wrapper in the slice, by the wrappers' counters."""

    @property
    def complete(self) -> bool:
        """Whether the trace holds a launch for every call counted."""
        return all(self.traced_calls(w) >= n for w, n in self.launches.items())

    def traced_calls(self, wrapper: str) -> int:
        return sum(self.by_port_kernel.get(k, (0, 0.0))[0] for k in ONCE_A_CALL[wrapper])

    def op_seconds(self, op: str) -> Tuple[int, float]:
        """(launches, seconds) of the port kernels of ``op``."""
        prefix = KERNEL_OPS[op]
        hits = [v for k, v in self.by_port_kernel.items() if k.startswith(prefix)]
        return sum(c for c, _ in hits), sum(s for _, s in hits)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Profiler:
    """``with Profiler() as p: ...`` profiles the block (from one device
    synchronise to another); ``p.reduce()`` reads it afterwards, outside the
    window: parsing the trace holds the interpreter for seconds, which
    would stall a load that runs on while the slice is reduced."""

    def __init__(self, kernel_names, launch_counts=dict):
        """``launch_counts()``: {kernel wrapper module: its launches}."""
        self.kernel_names = kernel_names
        self.launch_counts = launch_counts

    def _counts(self) -> Dict[str, int]:
        return {m.__name__.rsplit(".", 1)[-1]: n for m, n in self.launch_counts().items()}

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        _sync()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        if torch.cuda.is_available():
            # one kernel through the trace before the slice's own
            torch.zeros(1, device="cuda").add_(1)
            _sync()
        # counted once the trace is on: a launch counted is a launch traced
        self._before = self._counts()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        # counted before the last synchronise: every launch counted has run
        self._after = self._counts()
        _sync()
        self._t1 = time.perf_counter()
        self._prof.__exit__(*exc)
        return False

    def reduce(self) -> Slice:
        s = reduce_events(self._prof.events(), self.kernel_names)
        s.start, s.end = self._t0, self._t1
        s.launches = {w: n - self._before[w] for w, n in self._after.items()
                      if n > self._before[w] and w in ONCE_A_CALL}
        return s


def reduce_events(events, kernel_names) -> Slice:
    from torch.autograd import DeviceType

    kernels, host = [], []
    for e in events:
        if e.device_type != DeviceType.CUDA:
            host.append(e)
        elif not (getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX)):
            kernels.append(e)       # a span's copy on the device timeline is no kernel
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, union = 0.0, []
    for s, t in spans:
        if union and s <= union[-1][1]:
            union[-1][1] = max(union[-1][1], t)
        else:
            union.append([s, t])
    busy = sum(t - s for s, t in union)
    everything = kernels + host
    lo = min((e.time_range.start for e in everything), default=0.0)
    hi = max((e.time_range.end for e in everything), default=0.0)
    by_name: Dict[str, List] = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    by_port: Dict[str, List] = defaultdict(lambda: [0, 0.0])
    for name, (count, us) in by_name.items():
        k = port_kernel(name, kernel_names)
        if k is not None:
            by_port[k][0] += count
            by_port[k][1] += us
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return Slice(
        wall_s=(hi - lo) / 1e6, busy_s=busy / 1e6, kernels=len(kernels),
        kernel_s=sum(v[1] for v in by_name.values()) / 1e6,
        by_name={k: (c, us / 1e6) for k, (c, us) in by_name.items()},
        by_port_kernel={k: (c, us / 1e6) for k, (c, us) in by_port.items()},
        device_ops=[(k[:200], us / 1e6) for k, (_, us) in ranked[:10]],
        idle_gaps=_idle_gaps(union, host, lo, hi))


def _idle_gaps(union, host, lo: float, hi: float) -> List[Tuple[str, float]]:
    """The device's idle gaps in the slice, summed by the innermost host
    event open at each gap's middle; the ten largest."""
    gaps, last = [], lo
    for s, t in union:
        if s > last:
            gaps.append((last, s))
        last = max(last, t)
    if hi > last:
        gaps.append((last, hi))
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in host)
    starts = [s for s, _, _ in spans]
    by_host: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        if b - a < SHORT_GAP_US:
            by_host[f"gaps under {SHORT_GAP_US:g} us between kernels"] += (b - a) / 1e6
            continue
        mid = (a + b) / 2
        best = None
        # host events are few next to kernels; scan those that began before mid
        for s, t, name in spans[:bisect.bisect_right(starts, mid)]:
            if t >= mid and (best is None or t - s < best[0]):
                best = (t - s, name)
        by_host[best[1][:200] if best else "host: no event"] += (b - a) / 1e6
    return sorted(by_host.items(), key=lambda kv: -kv[1])[:10]


class OpLog(TorchDispatchMode):
    """Records (op name, flops, bytes) of every ``torch.ops.vct.*`` call
    with a cost function in ``flops.COSTS``."""

    def __init__(self):
        super().__init__()
        self.calls: List[Tuple[str, float, float]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "vct":
            name = func._opname
            if name in flops.COSTS:
                f, b = flops.COSTS[name](args, kwargs, out)
                self.calls.append((name, f, b))
        return out

    def bounds(self, pk: Dict[str, float]) -> Dict[str, Tuple[int, float]]:
        """{op: (calls, summed bound seconds)}."""
        out: Dict[str, List] = defaultdict(lambda: [0, 0.0])
        for name, f, b in self.calls:
            out[name][0] += 1
            out[name][1] += flops.bound_seconds(f, b, pk)
        return {k: (c, s) for k, (c, s) in out.items()}
