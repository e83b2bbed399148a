"""The readers of the program's spans (``program_spans.py`` and the four
``program_span`` metrics that call it) on synthetic spans and a synthetic
slice: their values, their None cases, spans outside the slice left out,
each metric given to its cell, a program without spans, and an untraced
run that records none."""
import sys
import time
import types

import pytest
from torch.profiler import ProfilerActivity, profile

from caption_bench import generator, harness, profiling, program_spans

MS = 1_000_000
T0 = 50_000 * 1_000_000_000           # the slice starts 50,000 s into perf_counter
NEW = {"server.worker_busy.served": "serving.open",
       "engine.frame_decode_ms.served": "serving.open",
       "engine.replay_ms.batch": "core.b8.warm",
       "engine.lookup_ms.batch": "core.b8.warm"}


def _slice(start_ns=T0, end_ns=T0 + 1000 * MS):
    return profiling.Slice(wall_s=(end_ns - start_ns) / 1e9, busy_s=0.0, kernels=0,
                           kernel_s=0.0, by_name={}, by_port_kernel={}, device_ops=[],
                           idle_gaps=[], start=start_ns / 1e9, end=end_ns / 1e9)


def _run(family, slice_=None):
    return harness.Readings(family=family, slice=slice_, outcome=generator.Outcome(window_s=20),
                            dispatch_videos=[], queue_wait_ms=[], latency_ms=[],
                            op_bounds=None, peaks=None, batch=8)


_ids = iter(range(1, 10_000))


def _span(name, start_ms, end_ms, parent=None, thread=1, **attrs):
    return types.SimpleNamespace(name=name, id=next(_ids), parent=parent, thread=thread,
                                 start=T0 + int(start_ms * MS), end=T0 + int(end_ms * MS),
                                 requests=(), attrs=attrs, counts={})


def _given(monkeypatch, spans):
    monkeypatch.setattr(program_spans, "program_spans", lambda: list(spans))


def _dispatch(start_ms, replay_ms, lookup_ms):
    d = _span("engine.dispatch", start_ms, start_ms + 30)
    return [d, _span("engine.lookup", start_ms + 1, start_ms + 1 + lookup_ms, parent=d.id),
            _span("engine.replay", start_ms + 10, start_ms + 10 + replay_ms, parent=d.id)]


def test_worker_busy_clips_idle_to_the_slice(monkeypatch):
    spans = [_span("queue.idle", -100, 100, thread=7),     # 100 ms of it inside
             _span("queue.coalesce", 100, 105, thread=7),
             _span("queue.idle", 400, 600, thread=7),
             _span("queue.idle", 950, 1300, thread=7),     # 50 ms of it inside
             _span("server.request", 0, 900, thread=3),    # a handler: not the worker
             _span("queue.idle", 0, 1000, thread=3)]
    _given(monkeypatch, spans[:5])
    assert program_spans.worker_busy(_run("served", _slice()), "served") == pytest.approx(65.0)
    # the busiest of two workers
    _given(monkeypatch, spans)
    assert program_spans.worker_busy(_run("served", _slice()), "served") == pytest.approx(65.0)


def test_frame_decode_per_frame_leaves_out_spans_across_the_edges(monkeypatch):
    _given(monkeypatch, [_span("engine.frame_decode", -5, 5, frames=16),
                         _span("engine.frame_decode", 100, 148, frames=16),
                         _span("engine.frame_decode", 200, 216, frames=8),
                         _span("engine.frame_decode", 995, 1010, frames=16),
                         _span("engine.frame_decode", 2000, 2050, frames=16)])
    assert program_spans.ms_per_frame(_run("served", _slice()), "served",
                                      "engine.frame_decode") == pytest.approx(64 / 24)


def test_per_dispatch_counts_the_dispatches_inside_and_their_own_spans(monkeypatch):
    inside = _dispatch(100, replay_ms=8, lookup_ms=2) + _dispatch(300, replay_ms=12,
                                                                  lookup_ms=1)
    edge = _dispatch(-20, replay_ms=15, lookup_ms=5)          # its replay falls inside
    stray = _span("engine.replay", 500, 520)                   # under no dispatch
    _given(monkeypatch, inside + edge + [stray])
    run = _run("batch", _slice())
    assert program_spans.ms_per_dispatch(run, "batch", "engine.replay") == pytest.approx(10.0)
    assert program_spans.ms_per_dispatch(run, "batch", "engine.lookup") == pytest.approx(1.5)
    # a replay under a capture under the dispatch still counts
    d = _span("engine.dispatch", 600, 700)
    cap = _span("engine.capture", 610, 650, parent=d.id)
    _given(monkeypatch, [d, cap, _span("engine.replay", 605, 690, parent=d.id),
                         _span("engine.lookup", 601, 602, parent=cap.id)])
    assert program_spans.ms_per_dispatch(run, "batch", "engine.lookup") == pytest.approx(1.0)


@pytest.mark.parametrize("name,family", [(n, "served" if c == "serving.open" else "batch")
                                         for n, c in NEW.items()])
def test_none_for_another_family_no_slice_or_no_span(monkeypatch, name, family):
    read = harness.load_reader(name)
    spans = _dispatch(100, 8, 2) + [_span("engine.frame_decode", 50, 60, frames=4),
                                    _span("queue.idle", 0, 10, thread=9)]
    _given(monkeypatch, spans)
    assert read(_run(family, _slice())) is not None
    other = "batch" if family == "served" else "served"
    assert read(_run(other, _slice())) is None
    assert read(_run(family, None)) is None
    assert read(_run(family, _slice(T0 + 5000 * MS, T0 + 6000 * MS))) is None
    _given(monkeypatch, [])
    assert read(_run(family, _slice())) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_new_metric_goes_to_its_cell_alone(name):
    spec = harness.load_spec()
    (entry,) = [m for m in spec["per_layer"] if m["name"] == name]
    assert entry["source"] == "program_span" and entry["workloads"] == [NEW[name]]
    for w in spec["workloads"]:
        given = {m["name"] for m in harness.resolve(spec, w["name"]).per_layer}
        assert (name in given) == (w["name"] == NEW[name])


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "video_caption_tpu_torch.tracing", None)
    assert program_spans.program_spans() == []
    for name, cell in NEW.items():
        family = "served" if cell == "serving.open" else "batch"
        assert harness.load_reader(name)(_run(family, _slice())) is None


def test_the_programs_own_spans_read_on_the_slices_clock():
    """Spans the program records under a profiler session, read through a
    slice stamped with ``time.perf_counter`` around them."""
    from video_caption_tpu_torch import tracing

    tracing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            start = time.perf_counter()
            for _ in range(2):
                with tracing.span("engine.dispatch"):
                    with tracing.span("engine.replay"):
                        time.sleep(0.004)
            end = time.perf_counter()
        value = harness.load_reader("engine.replay_ms.batch")(
            _run("batch", _slice(int(start * 1e9), int(end * 1e9))))
    finally:
        tracing.reset()
    assert 4.0 <= value < 50.0


def test_an_untraced_run_records_no_span():
    """``--trace 0`` starts no profiler session: the program's spans and
    counters stay empty through the whole run."""
    from bench_helpers import tiny_cell

    from video_caption_tpu_torch import tracing

    tracing.reset()
    result = harness.run_cell(tiny_cell("served"), 2 ** 31 + 9, 1.0, False, device="cpu")
    assert result["attempted"] > 0 and result["failed"] == 0
    assert tracing.spans() == [] and tracing.counters() == {}
