"""Captured request programs and the serialized request artifact: the
counterpart of video_caption_tpu/aot.py.

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
disk. The serialized artifact is a ``torch.export`` archive (``.pt2``), not
StableHLO: the program's operator graph, in which each hand-written kernel
is a call of its custom op (``torch.ops.vct.*``, registered when the
kernel modules are imported, as this module does).

- :func:`export_program` serializes a function of tensors (the
  counterpart of ``export_stablehlo``).
- :func:`export_request_program` serializes the engine's request program
  with the weights, the uint8 video and the sampled groups' Gumbel noise
  as inputs (the JAX package's takes ``(params, video, key)``): no weights
  and no generator are baked in, so the artifact's ids equal the live
  engine's on the same noise.
- :class:`AotRuntime` loads artifacts and runs them; a loaded request
  program can be captured into a :class:`RequestGraph` like the live one.

An artifact runs on the device type it was exported on. Graphs exist only
on CUDA; a CPU tensor is refused.
"""
from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from video_caption_tpu_torch.ops import (beam_attention, decode_attention, decode_layer,
                                         encoder_attention, fused_pool, lm_head, norm_act,
                                         prefix_projector)

log = logging.getLogger(__name__)

KERNEL_MODULES = (encoder_attention, prefix_projector, lm_head, beam_attention,
                  decode_attention, decode_layer, fused_pool, norm_act)
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


class _Program(torch.nn.Module):
    """A function of tensors as the module ``torch.export`` takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(fn: Callable, args: Tuple, out_path: str) -> str:
    """Trace ``fn(*args)`` with ``torch.export`` (under ``no_grad``) and
    write the program to ``out_path`` as a ``.pt2`` archive; returns the
    path. The shapes of ``args`` are fixed in it, their values are not
    stored; tensors ``fn`` reaches other than through ``args`` are stored
    in it as constants."""
    with torch.no_grad():
        exported = torch.export.export(_Program(fn), tuple(args))
    exported.example_inputs = None      # else the archive stores args (the weights) too
    path = Path(out_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(exported, str(path))
    log.info("exported %d bytes of torch.export program to %s", path.stat().st_size, path)
    return str(path)


def export_request_program(engine, out_path: str) -> str:
    """Serialize the engine's single-video request program (the program its
    request graph captures, ``engine._fused_infer_program``) from its core
    ``core(params, video, noises)``: the weights (``engine.params``' tree),
    a uint8 video [1,T,3,S,S] and ``engine.request_noise(1)``'s tuple are
    the artifact's inputs. Run it with ``AotRuntime.run(name, params,
    video, noises)``. Raises ValueError for an engine with early stop, whose
    request reads its stop condition on the host and is never captured."""
    program, group_list = engine._fused_infer_program()
    if any(dp.early_stop for dp, *_ in group_list):
        raise ValueError("early_stop_decode: the request reads its stop condition on the host "
                         "before every step, so it has no fixed program to export")
    c = engine.config
    video = torch.zeros((1, c.num_frames, 3, c.image_size, c.image_size), dtype=torch.uint8,
                        device=engine.device)
    noises = engine.request_noise(1, torch.Generator(device=engine.device).manual_seed(0))
    return export_program(program.core, (engine.params, video, noises), out_path)


class AotRuntime:
    """Loads serialized programs and runs them (core/trt/runtime.py analog)."""

    def __init__(self):
        self._programs: Dict[str, Any] = {}

    def load(self, name: str, path: str) -> None:
        """Load the ``.pt2`` archive at ``path`` under ``name``."""
        self._programs[name] = torch.export.load(str(path)).module()

    def run(self, name: str, *args):
        """The outputs of program ``name`` on ``args`` (in inference mode);
        KeyError if no program of that name is loaded."""
        if name not in self._programs:
            raise KeyError(f"program {name!r} not loaded")
        with torch.inference_mode():
            return self._programs[name](*args)
