"""The port's kernels as ``torch.library`` custom ops (``torch.ops.vct.*``)
on the CPU: ``opcheck`` of each op (schema, fake implementation, autograd
registration, tracing), its CPU kernel equal to the plain version, its fake
implementation's shapes, strides and dtypes equal to the real outputs', the
five registered backward passes against autograd through the plain
versions, and one export and round trip of the request program in each
decode configuration whose kernel the default one does not reach (and one
with its LayerNorms and GELUs dispatched to the norm_act ops), at the
conftest's tiny geometry in f32 (tests/torch_op_cases.py holds the ops'
inputs; tests/test_torch_cuda_kernels.py runs the same cases on the card)."""
import dataclasses

import pytest
import torch

from test_torch_aot import _engine, _video, port_params  # noqa: F401
from torch_op_cases import CASE_IDS, GRAD_OPS, cases, to_meta
from video_caption_tpu_torch import aot
from video_caption_tpu_torch.ops import norm_act

STEPS = 4   # decode steps of the exported programs (every group cut to it)


def _case(case_id):
    return next(c for c in cases() if c.id == case_id)


def test_every_kernel_is_a_custom_op():
    ops = {c.name for c in cases()}
    assert ops == {"encoder_attention", "prefix_project", "lm_head_stats", "beam_attention",
                   "decode_attention", "decode_layer", "fused_pool", "layer_norm", "gelu"}
    # norm_act holds two ops: the LayerNorm's as its _op, the GELU's beside it
    assert {m._op._qualname for m in aot.KERNEL_MODULES} | {norm_act._gelu_op._qualname} \
        == {f"vct::{n}" for n in ops}


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_opcheck(case_id):
    case = _case(case_id)
    args = case.fresh_args()
    if case.name in GRAD_OPS:
        args = (args[0].requires_grad_(),) + tuple(
            a.requires_grad_() if isinstance(a, torch.Tensor) else a for a in args[1:])
    torch.library.opcheck(case.op, args)


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_cpu_kernel_is_the_plain_version(case_id):
    case = _case(case_id)
    got, want = case.run(), case.run_plain()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("case_id", CASE_IDS)
def test_fake_implementation_matches_the_cpu_kernel(case_id):
    """The fake implementation on meta tensors gives the real output's
    shape, strides and dtype."""
    case = _case(case_id)
    real = case.op(*case.fresh_args())
    fake = case.op(*to_meta(case.fresh_args()))
    assert fake.device.type == "meta"
    assert (fake.shape, fake.stride(), fake.dtype) == (real.shape, real.stride(), real.dtype)


@pytest.mark.parametrize("case_id", [c for c in CASE_IDS if _case(c).name in GRAD_OPS])
def test_registered_backward_matches_autograd_of_the_plain_version(case_id):
    """Input gradients through the op (its registered backward) against
    autograd through the plain version, for a random output gradient."""
    case = _case(case_id)
    tensors = [i for i, a in enumerate(case.args) if isinstance(a, torch.Tensor)]
    grads = []
    for fn in (case.op, lambda *a: case.plain(*a)[0]):
        args = list(case.fresh_args())
        for i in tensors:
            args[i].requires_grad_()
        out = fn(*args)
        up = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
        grads.append(torch.autograd.grad(out, [args[i] for i in tensors], up))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


CONFIGS = {
    "use_pallas_decode_attention": ({"unified_fused_request": False}, "decode_attention"),
    "use_pallas_decode_layer": ({}, "decode_layer"),
    "deferred_decode_cache_write": ({}, "beam_attention"),
    "quantize_decoder_int8": ({}, "beam_attention"),
}


@pytest.mark.parametrize("switch", list(CONFIGS))
def test_export_round_trip_in_each_decode_configuration(tiny_cfg, port_params, switch,  # noqa: F811
                                                        tmp_path):
    """The request program of an engine with ``switch`` on (and the
    default presets, every group cut to STEPS steps) exported, loaded and
    run: the ids of every group equal the live program's on the same
    draws, and the graph calls the configuration's kernel op. The
    decode-layer op writes its cache in place in the archive too: every
    step's call takes the same cache node, so no step copies it; the
    deferred engine's beam_attention calls take the step's own K/V."""
    extra, kernel = CONFIGS[switch]
    decode = switch if switch != "quantize_decoder_int8" else "default"
    kw = {switch: True} if decode == "default" else {}
    engine = _engine(tiny_cfg, port_params, decode, seed=5, **kw, **extra)
    engine._groups = [(dataclasses.replace(dp, max_new_tokens=STEPS), *rest)
                      for dp, *rest in engine._decode_groups()]
    path = aot.export_request_program(engine, str(tmp_path / "request.pt2"))
    rt = aot.AotRuntime()
    rt.load("request", path)
    program, groups = engine._fused_infer_program()
    video = _video(4)
    state = engine.generator.get_state()
    noises = engine.request_noise(1)
    engine.generator.set_state(state)
    live = program(video)
    got = rt.run("request", engine.params, video, noises)
    assert len(got) == len(live) == len(groups) == 2
    for a, b in zip(got, live):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    calls = [n for n in torch.export.load(path).graph.nodes
             if n.op == "call_function" and str(n.target) == f"vct.{kernel}.default"]
    assert calls
    if switch == "use_pallas_decode_layer":
        assert len(calls) == STEPS - 1
        assert len({n.args[1] for n in calls}) == 1
    if switch == "deferred_decode_cache_write":
        assert all(n.args[9] is not None and n.args[10] is not None for n in calls)
    if switch == "quantize_decoder_int8":
        assert any(t.dtype == torch.int8 for t in engine.params["decoder"]["blocks"].values())


def test_export_round_trip_with_the_norm_act_ops(tiny_cfg, port_params, tmp_path,  # noqa: F811
                                                 monkeypatch):
    """The request program with its LayerNorms and f32 GELUs dispatched to
    ``vct::layer_norm`` and ``vct::gelu`` (a CPU tensor runs the plain
    version without the op; here the dispatch is forced to the ops, whose CPU
    kernels are that version) exports with both ops in its graph, one call
    for each LayerNorm and GELU of the ViT and of every GPT-2 forward, and
    the archive's ids equal the live program's on the same draws."""
    monkeypatch.setattr(norm_act, "takes_kernel", lambda x: True)
    engine = _engine(tiny_cfg, port_params, seed=5)
    engine._groups = [(dataclasses.replace(dp, max_new_tokens=STEPS), *rest)
                      for dp, *rest in engine._decode_groups()]
    path = aot.export_request_program(engine, str(tmp_path / "request.pt2"))
    rt = aot.AotRuntime()
    rt.load("request", path)
    program, _ = engine._fused_infer_program()
    video = _video(4)
    state = engine.generator.get_state()
    noises = engine.request_noise(1)
    engine.generator.set_state(state)
    live = program(video)
    got = rt.run("request", engine.params, video, noises)
    assert len(got) == len(live) == 2
    for a, b in zip(got, live):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    targets = [str(n.target) for n in torch.export.load(path).graph.nodes
               if n.op == "call_function"]
    vit_layers, gpt2_layers = engine.model_cfg.vit.depth, engine.model_cfg.gpt2.n_layer
    forwards = STEPS         # the unified loop: the prefill and STEPS - 1 steps
    assert targets.count("vct.layer_norm.default") == 2 * vit_layers + 1 \
        + forwards * (2 * gpt2_layers + 1)
    assert targets.count("vct.gelu.default") == vit_layers + forwards * gpt2_layers
