"""Captured request programs: the counterpart of video_caption_tpu/aot.py.

On the TPU the JAX package lowers and compiles its request program once
(``jax.jit(...).lower().compile()``) and calls the executable for every
request. On the GPU the counterpart is a ``torch.cuda.CUDAGraph``: the
program's kernels are captured once and every request replays them with
one host call, instead of the host issuing each of the request's kernels.

- :class:`RequestGraph` captures ``fn(x) -> outputs`` into a graph with a
  static input buffer and static outputs, and replays it.
- :func:`graphed` gives a function as a replay of its graph on CUDA, and as
  itself on the CPU (the benchmarks time their stages through it).
- :func:`build_engine` captures the pipeline's stages in the reference's
  rollout order (encoder, projector, decoder) and reports the capture time
  of each.

A captured graph holds raw device pointers, so it cannot be written to
disk: the JAX package's serialized artifact (``export_stablehlo``,
``export_request_program``, ``AotRuntime``) is not ported. Graphs exist
only on CUDA; a CPU tensor is refused.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from video_caption_tpu_torch.ops import (beam_attention, decode_attention, decode_layer,
                                         encoder_attention, fused_pool, lm_head,
                                         prefix_projector)

log = logging.getLogger(__name__)

KERNEL_MODULES = (encoder_attention, prefix_projector, lm_head, beam_attention,
                  decode_attention, decode_layer, fused_pool)
"""The kernel wrappers whose ``launches`` counters a replay keeps up to date."""


def launch_counts() -> Dict[object, int]:
    """{wrapper module: its ``launches``} of every kernel wrapper."""
    return {m: m.launches for m in KERNEL_MODULES}


def _require_cuda_device(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"CUDA graphs exist only on CUDA devices, not on {device}")
    return device


class RequestGraph:
    """A program captured once into ``graph`` and replayed: ``static_input``
    is the buffer the capture read its input from, ``outputs`` what the
    capture returned (overwritten in place by every replay), ``launches``
    {kernel wrapper module: launches of its kernel during the capture};
    ``warmup_s`` and ``capture_s`` the seconds of the run before the
    capture and of the capture with the graph's instantiation.

    The wrappers count a launch on the host when they issue it, and a
    replay issues nothing from Python, so :meth:`replay` adds ``launches``
    to the wrappers' counters: the counts stay the launches that ran."""

    def __init__(self, graph, static_input: torch.Tensor, outputs,
                 launches: Dict[object, int], warmup_s: float = 0.0, capture_s: float = 0.0):
        self.graph = graph
        self.static_input = static_input
        self.outputs = outputs
        self.launches = launches
        self.warmup_s = warmup_s
        self.capture_s = capture_s

    @classmethod
    def capture(cls, fn: Callable[[torch.Tensor], object], example: torch.Tensor,
                generators: Sequence[torch.Generator] = ()) -> "RequestGraph":
        """Capture ``fn(static_input)``, the static input a copy of
        ``example``. As PyTorch's graph documentation asks, ``fn`` first runs
        once on the capture stream outside the capture: that builds the
        kernels, fills the launch-plan caches, creates the state a wrapper
        keeps per stream (decode_layer's tickets) and grows the allocator,
        so none of it happens inside the capture. The ``generators`` are
        set back to their state before that run and registered with the
        graph: every replay then draws what the same call made eagerly
        would draw, and advances them as much. Several graphs may register
        one generator: each replay reads the generator's offset when it is
        issued and advances it by its capture's draws, so replays in any
        order draw what the eager calls in that order draw.

        The capture runs in ``thread_local`` mode: only the capturing
        thread is refused calls that are unsafe during a capture, so a
        server thread that builds another engine meanwhile (allocations,
        uploads) does not invalidate it. Raises if the capture fails;
        there is no fallback."""
        device = _require_cuda_device(example.device)
        t0 = time.perf_counter()
        static_input = example.clone()
        states = [g.get_state() for g in generators]
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            fn(static_input)
        torch.cuda.current_stream(device).wait_stream(stream)
        for g, state in zip(generators, states):
            g.set_state(state)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        before = launch_counts()
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            outputs = fn(static_input)
        torch.cuda.synchronize(device)
        launches = {m: n - before[m] for m, n in launch_counts().items() if n != before[m]}
        return cls(graph, static_input, outputs, launches, t1 - t0, time.perf_counter() - t1)

    def replay(self, x: torch.Tensor):
        """Copy ``x`` into the static input, replay, and return the static
        outputs (valid until the next replay)."""
        self.static_input.copy_(x)
        self.graph.replay()
        for module, n in self.launches.items():
            module.launches += n
        return self.outputs


def graphed(fn: Callable[[torch.Tensor], object], example: torch.Tensor,
            generators: Sequence[torch.Generator] = ()) -> Callable[[torch.Tensor], object]:
    """``fn`` for repeated calls on inputs of ``example``'s shape: on CUDA
    the replay of a :class:`RequestGraph` of ``fn`` captured now (its
    outputs overwritten by the next call), on the CPU ``fn`` itself."""
    if example.device.type != "cuda":
        return fn
    return RequestGraph.capture(fn, example, generators).replay


def build_engine(config=None, stages: Tuple[str, ...] = ("encoder", "projector", "decoder"),
                 device="cuda", seed: int = 0) -> Dict[str, Dict[str, Optional[float]]]:
    """Capture the pipeline stages in the reference's rollout order on
    ``device`` (CUDA only). Returns {stage: {compile_s, flops}}: the capture
    time (the warm-up run before it, which builds the kernels on first
    use, not counted), and ``flops`` None (a graph has no counterpart of
    XLA's cost analysis; the JAX package reports None as well when it
    cannot tell)."""
    from video_caption_tpu_torch.config import default_inference_config
    from video_caption_tpu_torch.decode.generate import DecodeParams, greedy_or_sample
    from video_caption_tpu_torch.engine import InferenceEngine
    from video_caption_tpu_torch.models import caption_model as cm
    from video_caption_tpu_torch.ops.prefix_norm import apply_prefix_norm

    device = _require_cuda_device(device)
    engine = InferenceEngine(config or default_inference_config(), seed=seed, device=device)
    params, mc, c = engine.params, engine.model_cfg, engine.config
    report: Dict[str, Dict[str, Optional[float]]] = {}

    def capture_stage(name: str, fn: Callable, example: torch.Tensor) -> None:
        def run(x):
            with torch.inference_mode():
                return fn(x)

        graph = RequestGraph.capture(run, example, (engine.generator,))
        report[name] = {"compile_s": graph.capture_s, "flops": None}
        log.info("captured %s: %.2fs", name, graph.capture_s)

    if "encoder" in stages:
        video = torch.zeros((1, c.num_frames, 3, c.image_size, c.image_size), dtype=torch.uint8,
                            device=device)
        capture_stage("encoder", lambda v: cm.encode_video(params, v, mc), video)
    if "projector" in stages:
        capture_stage("projector", lambda e: cm.map_prefix(
            params, apply_prefix_norm(e, mc.ln_scale, mc.in_weight), mc),
            torch.zeros((1, mc.video_dim), device=device))
    if "decoder" in stages:
        dp = DecodeParams(max_new_tokens=8, num_beams=1)
        embeds = torch.zeros((1, mc.prefix_len + 1, mc.gpt2.n_embd), dtype=mc.gpt2.dtype,
                             device=device)
        capture_stage("decoder", lambda e: greedy_or_sample(
            params["decoder"], mc.gpt2, e, dp, engine.generator), embeds)
    return report
