"""Spans and counters at the layer boundaries of the server and the engine,
recorded in memory while a torch profiler session runs.

The switch is torch's own: ``torch.autograd.profiler._is_profiler_enabled``,
which ``torch.profiler.profile`` sets for the whole process while a session
runs, whatever thread entered it (``enabled``). There is no other switch:
an operator traces by profiling (``cli/profile_request.py``, or any
``with torch.profiler.profile(...)`` block). With no session, ``span``
returns one shared no-op context and ``count`` returns at once: a span
costs one read of the switch, and reads no clock.

- ``span(name, parent=None, requests=None, **attrs)``: a context that
  records its name, an id, its parent's id, the thread, start and end
  (``time.perf_counter_ns``), the request ids it serves and small integer
  attrs. The parent is the innermost span open on the thread, or
  ``parent`` where work moved to another thread; the request ids are
  ``requests``, else the parent's. While it is open the span is also a
  ``torch.profiler.record_function``, so it lands in the profiler's host
  timeline on every thread the profiler records.
- ``request(name)``: a span that starts a request: it takes a new request
  id, which every span under it carries.
- ``count(name, n=1)``: adds ``n`` to the process's ``counters()`` and to
  the counts of the innermost span open on the thread, so a reader can sum
  the counts of the spans inside a window.
- ``waiting(name)``: a span around a blocking wait, kept where a session
  ran at its start or at its end (its edges may straddle one).
- ``stamp(obj)``, ``since(name, obj)``, ``requests_of(objs)``: a span from
  a stamp taken on one thread to a moment on another (a request's wait in a
  queue), and the request ids stamped on a batch's objects.
- ``spans()``, ``counters()``, ``dropped()``, ``reset()``: the finished
  spans, oldest first, from a bounded buffer that drops the oldest and
  counts what it dropped. Nothing is written anywhere else.
- ``unix_ns(t)``: a ``perf_counter_ns`` stamp on the Unix clock, the base of
  the profiler's host events (``trace_start_ns`` plus an event's start), so
  a span can be placed on a device trace's timeline.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

import torch.autograd.profiler as _autograd_profiler

CAPACITY = 1 << 16
"""Finished spans kept; past it the oldest go (``dropped``)."""

_ANCHOR = (time.perf_counter_ns(), time.time_ns())
_ids = itertools.count(1)
_request_ids = itertools.count(1)
_lock = threading.Lock()
_buffer: deque = deque(maxlen=CAPACITY)
_counters: Dict[str, int] = {}
_dropped = 0
_local = threading.local()


def enabled() -> bool:
    """Whether a torch profiler session runs in this process."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(span: "Span") -> None:
    global _dropped
    with _lock:
        if len(_buffer) == CAPACITY:
            _dropped += 1
        _buffer.append(span)


class Span:
    """One span: open while its ``with`` block runs, then a record in
    ``spans()``. Times are ``perf_counter_ns``; ``parent`` is the parent's
    id or None; ``thread`` is ``threading.get_ident()``."""

    __slots__ = ("name", "id", "parent", "thread", "start", "end", "requests", "attrs",
                 "counts", "_function")

    def __init__(self, name: str, parent: Optional["Span"], requests: Optional[tuple],
                 attrs: dict):
        self.name = name
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        if requests is None:
            requests = parent.requests if parent is not None else ()
        self.requests = tuple(requests)
        self.attrs = attrs
        self.counts: Dict[str, int] = {}
        self.thread = 0
        self.start = self.end = 0
        self._function = None

    def __enter__(self) -> "Span":
        self.thread = threading.get_ident()
        _stack().append(self)
        self._function = _autograd_profiler.record_function(self.name)
        self._function.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter_ns()
        self._function.__exit__(*exc)
        self._function = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _keep(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"requests={self.requests}, {(self.end - self.start) / 1e6:.3f} ms, "
                f"attrs={self.attrs}, counts={self.counts})")


class _NoSpan:
    """The shared context of every span taken with no session running."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


def _open_parent(parent) -> Optional[Span]:
    if isinstance(parent, Span):
        return parent
    stack = _stack()
    return stack[-1] if stack else None


def span(name: str, parent=None, requests: Optional[Iterable[int]] = None, **attrs):
    """A span of ``name`` (module docstring); ``NO_SPAN`` with no session.
    ``parent``: the span this one serves where it runs on another thread
    (a ``NO_SPAN`` parent is none)."""
    if not enabled():
        return NO_SPAN
    return Span(name, _open_parent(parent), requests, attrs)


def request(name: str, **attrs):
    """A span that starts a request under a new request id."""
    if not enabled():
        return NO_SPAN
    return Span(name, _open_parent(None), (next(_request_ids),), attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` and to the counts of the innermost span
    open on this thread (nothing for 0)."""
    if not n or not enabled():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
    stack = _stack()
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def annotate(**attrs) -> None:
    """Set attrs of the innermost span open on this thread."""
    if not enabled():
        return
    stack = _stack()
    if stack:
        stack[-1].attrs.update(attrs)


class _Waiting:
    __slots__ = ("name", "on", "span", "t")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Waiting":
        self.on = enabled()
        self.span = Span(self.name, _open_parent(None), None, {}) if self.on else None
        if self.span is not None:
            self.span.__enter__()
        self.t = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.span is not None:
            self.span.__exit__(*exc)
        elif enabled():
            record(self.name, self.t, time.perf_counter_ns())
        return False


def waiting(name: str) -> _Waiting:
    """A span around a blocking wait (a worker blocked on an empty queue):
    kept where a session ran at either of its ends. It reads the clock
    with no session running too."""
    return _Waiting(name)


def record(name: str, start: int, end: int, requests: Optional[Iterable[int]] = None,
           **attrs) -> None:
    """A span of ``name`` from ``start`` to ``end`` (``perf_counter_ns``)
    on this thread, under the innermost span open on it; kept while a
    session runs. It has no ``record_function`` copy."""
    if not enabled():
        return
    s = Span(name, _open_parent(None), requests, attrs)
    s.thread, s.start, s.end = threading.get_ident(), start, end
    _keep(s)


def stamp(obj) -> None:
    """Mark ``obj`` (a request's future) with the time and the request ids
    of the innermost span open on this thread, or a new request id."""
    if not enabled():
        return
    stack = _stack()
    requests = stack[-1].requests if stack else ()
    obj._trace_stamp = (time.perf_counter_ns(), requests or (next(_request_ids),))


def since(name: str, obj) -> None:
    """A span of ``name`` from ``obj``'s stamp to now, carrying its request
    ids (nothing where ``obj`` has no stamp)."""
    if obj is None or not enabled():
        return
    mark = getattr(obj, "_trace_stamp", None)
    if mark is not None:
        record(name, mark[0], time.perf_counter_ns(), requests=mark[1])


def requests_of(objs: Iterable) -> Optional[Tuple[int, ...]]:
    """The request ids stamped on ``objs``, in order; None with no session."""
    if not enabled():
        return None
    out: List[int] = []
    for obj in objs:
        mark = getattr(obj, "_trace_stamp", None)
        if mark is not None:
            out.extend(mark[1])
    return tuple(out)


def unix_ns(t: int) -> int:
    """``t`` (``perf_counter_ns``) on the Unix clock (``time.time_ns``)."""
    return t - _ANCHOR[0] + _ANCHOR[1]


def spans() -> List[Span]:
    """The finished spans kept, oldest first."""
    with _lock:
        return list(_buffer)


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def dropped() -> int:
    """Spans the buffer dropped since the last ``reset``."""
    return _dropped


def reset() -> None:
    global _dropped
    with _lock:
        _buffer.clear()
        _counters.clear()
        _dropped = 0
