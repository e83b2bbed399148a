"""The port's weight-only int8 decoder (video_caption_tpu_torch/models/quantize.py
and its use in models/gpt2.py, decode/ and the engine) against the JAX
package's, on the CPU at the conftest's tiny geometry in f32.

Tolerances: ``q`` bit-equal and the scales within 1e-7 relative (both
packages divide the same f32 max by 127 and round half to even); one int8
forward's logits within 1e-4 + 1e-4 relative; greedy, beam-3 and beam-5 ids
identical; the int8 engine's results equal to the JAX int8 engine's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_aot import WordTok, port_cfg, port_params  # noqa: F401
from video_caption_tpu.config import default_inference_config as jax_default_config
from video_caption_tpu.decode import generate as jgen
from video_caption_tpu.engine import InferenceEngine as JaxEngine
from video_caption_tpu.models import gpt2 as jg2
from video_caption_tpu.models import quantize as jq
from video_caption_tpu_torch.config import default_inference_config
from video_caption_tpu_torch.decode import generate as gen
from video_caption_tpu_torch.engine import InferenceEngine
from video_caption_tpu_torch.models import gpt2 as g2
from video_caption_tpu_torch.models import quantize as q
from video_caption_tpu_torch.models.convert import params_from_jax_numpy


def _weights(case):
    rng = np.random.RandomState(case)
    w = (rng.randn(3, 48, 40) * 0.05).astype(np.float32)
    if case == 1:
        w[:, :, 0] = 0.0                                   # the 1e-8 floor of the scale
        w[:, :, 1] = np.arange(48, dtype=np.float32) - 23.5   # halves: round half to even
        w[:, 0, 1] = 127.0
    return w


@pytest.mark.parametrize("case", [0, 1, 2])
def test_quantize_weight_matches_jax(case):
    w = _weights(case)
    want = jq.quantize_weight(jnp.asarray(w))
    got = q.quantize_weight(torch.from_numpy(w))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]), rtol=1e-7, atol=0)
    back = q.dequantize_weight(got, torch.float32).numpy()
    np.testing.assert_array_equal(back, np.asarray(jq.dequantize_weight(want, jnp.float32)))
    assert q.quantization_error(torch.from_numpy(w)) == pytest.approx(
        jq.quantization_error(jnp.asarray(w)), rel=1e-6)


def test_quantize_bf16_weights_matches_jax():
    """The engine quantizes the bf16-rounded weights; the port quantizes the
    same values as the JAX package, and not the f32 originals."""
    w = _weights(2)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    want = jq.quantize_weight(wb)
    got = q.quantize_weight(torch.from_numpy(w).to(torch.bfloat16))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]), rtol=1e-7, atol=0)
    assert not np.array_equal(got["q"].numpy(), q.quantize_weight(torch.from_numpy(w))["q"].numpy())


@pytest.fixture(scope="module")
def quantized(tiny_cfg, tiny_params, port_params):  # noqa: F811
    jdec = jq.quantize_gpt2_blocks(tiny_params["decoder"])
    tdec = q.quantize_gpt2_blocks(port_params["decoder"])
    return jdec, tiny_cfg.gpt2, tdec, port_cfg(tiny_cfg).gpt2


def test_quantize_gpt2_blocks_matches_jax(quantized):
    jdec, _, tdec, _ = quantized
    assert sorted(tdec["blocks"]) == sorted(jdec["blocks"])
    for name in q.QUANTIZED_BLOCK_WEIGHTS:
        assert name not in tdec["blocks"]
        assert tdec["blocks"][name + "_q"].dtype == torch.int8
        np.testing.assert_array_equal(tdec["blocks"][name + "_q"].numpy(),
                                      np.asarray(jdec["blocks"][name + "_q"]))
        np.testing.assert_allclose(tdec["blocks"][name + "_s"].numpy(),
                                   np.asarray(jdec["blocks"][name + "_s"]), rtol=1e-7, atol=0)
    assert q.is_quantized(tdec["blocks"]) and q.is_scale(tdec["blocks"], "fc_w_s")
    assert not q.is_scale(tdec["blocks"], "ln1_scale")


def test_int8_forward_logits_match_jax(quantized):
    jdec, jcfg, tdec, tcfg = quantized
    rng = np.random.RandomState(1)
    emb = (rng.randn(2, 5, tcfg.n_embd) * 0.1).astype(np.float32)
    pos = np.broadcast_to(np.arange(5), (2, 5)).astype(np.int32)
    mask = np.ones((2, 5), np.int32)
    want = np.asarray(jg2.gpt2_logits_nocache(jdec, jnp.asarray(emb), jnp.asarray(pos),
                                              jnp.asarray(mask), jcfg))
    got = g2.gpt2_logits_nocache(tdec, torch.from_numpy(emb), torch.from_numpy(pos).long(),
                                 torch.from_numpy(mask), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("beams", [1, 3, 5])
def test_int8_decode_ids_match_jax(quantized, beams):
    jdec, jcfg, tdec, tcfg = quantized
    rng = np.random.RandomState(2)
    prefix = (rng.randn(2, 4, tcfg.n_embd) * 0.1).astype(np.float32)
    ids = np.array([[127, 127, 5, 6], [7, 8, 9, 10]], np.int32)
    mask = (ids != 127).astype(np.int32)
    kw = dict(max_new_tokens=8, num_beams=beams, min_new_tokens=2, eos_id=127)
    want = np.asarray(jgen.generate_prefixed(jdec, jcfg, jnp.asarray(prefix), jnp.asarray(ids),
                                             jnp.asarray(mask), jgen.DecodeParams(**kw)))
    got = gen.generate_prefixed(tdec, tcfg, torch.from_numpy(prefix), torch.from_numpy(ids),
                                torch.from_numpy(mask), gen.DecodeParams(**kw)).numpy()
    np.testing.assert_array_equal(got, want)


def test_convert_carries_a_quantized_jax_tree(quantized, tiny_cfg):
    """``params_from_jax_numpy`` with a bf16 cast: ``*_q`` stay int8 and
    ``*_s`` f32, exactly the JAX package's, and nothing is quantized again."""
    jdec = quantized[0]
    tree = params_from_jax_numpy(jax.tree.map(np.asarray, {"decoder": jdec}),
                                 port_cfg(tiny_cfg), "cpu", dtype=torch.bfloat16)["decoder"]
    for name in q.QUANTIZED_BLOCK_WEIGHTS:
        np.testing.assert_array_equal(tree["blocks"][name + "_q"].numpy(),
                                      np.asarray(jdec["blocks"][name + "_q"]))
        assert tree["blocks"][name + "_s"].dtype == torch.float32
        np.testing.assert_array_equal(tree["blocks"][name + "_s"].numpy(),
                                      np.asarray(jdec["blocks"][name + "_s"]))
    assert tree["blocks"]["attn_b"].dtype == torch.bfloat16
    assert q.quantize_gpt2_blocks(tree)["blocks"].keys() == tree["blocks"].keys()


def test_decode_layer_refuses_int8_blocks(quantized):
    _, _, tdec, tcfg = quantized
    with pytest.raises(ValueError, match="plain weights"):
        g2.prepare_decode_params(tdec, dataclasses.replace(tcfg, use_pallas_decode_layer=True))


def _int8_config(**compile_kw):
    cfg = default_inference_config(ckpt="missing.pt", num_frames=2, image_size=32,
                                   preset1="precise", preset2="detailed", preset3="precise",
                                   prompt3="Another prompt:")
    return dataclasses.replace(cfg, compile=dataclasses.replace(
        cfg.compile, quantize_decoder_int8=True, **compile_kw))


def test_int8_engine_turns_decode_layer_off_and_keeps_scales_f32(tiny_cfg, port_params,  # noqa: F811
                                                                  caplog):
    """Under int8 the engine quantizes after the bf16 cast (q of the bf16
    weights, f32 scales), keeps the int8 tensors, and switches
    use_pallas_decode_layer off with a log line instead of raising."""
    pcfg = port_cfg(tiny_cfg)
    bf16 = dataclasses.replace(pcfg, vit=dataclasses.replace(pcfg.vit, dtype=torch.bfloat16),
                               gpt2=dataclasses.replace(pcfg.gpt2, dtype=torch.bfloat16,
                                                        use_pallas_decode_layer=True))
    with caplog.at_level("INFO", logger="video_caption_tpu_torch.engine"):
        eng = InferenceEngine(_int8_config(use_pallas_decode_layer=True), params=port_params,
                              model_cfg=bf16, device="cpu")
    assert not eng.model_cfg.gpt2.use_pallas_decode_layer
    assert any("use_pallas_decode_layer is off" in r.message for r in caplog.records)
    blocks = eng.params["decoder"]["blocks"]
    w = jnp.asarray(port_params["decoder"]["blocks"]["fc_w"].numpy()).astype(jnp.bfloat16)
    want = jq.quantize_weight(w)
    assert blocks["fc_w_q"].dtype == torch.int8 and blocks["fc_w_s"].dtype == torch.float32
    np.testing.assert_array_equal(blocks["fc_w_q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_allclose(blocks["fc_w_s"].numpy(), np.asarray(want["scale"]), rtol=1e-7)
    assert blocks["fc_b"].dtype == torch.bfloat16 and "fc_w" not in blocks


def test_int8_engine_results_match_the_jax_int8_engine(tiny_cfg, tiny_params, port_params,  # noqa: F811
                                                       tmp_path):
    """Beam presets (two policy groups, the unified program) under int8:
    the same ``to_api_dict()`` as the JAX int8 engine, and the same ids as
    the port's own grouped program."""
    from PIL import Image

    rng = np.random.RandomState(4)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(
            tmp_path / f"frame_{i:05d}.jpg")
    jcfg = jax_default_config(ckpt="missing.pt", num_frames=2, image_size=32,
                              preset1="precise", preset2="detailed", preset3="precise",
                              prompt3="Another prompt:")
    jcfg = dataclasses.replace(jcfg, compile=dataclasses.replace(jcfg.compile,
                                                                 quantize_decoder_int8=True))
    jax_engine = JaxEngine(jcfg, params=tiny_params, model_cfg=tiny_cfg)
    jax_engine.tokenizer = WordTok()
    engines = []
    for kw in ({}, {"unified_fused_request": False}):
        eng = InferenceEngine(_int8_config(**kw), params=port_params, model_cfg=port_cfg(tiny_cfg),
                              device="cpu")
        eng.tokenizer = WordTok()
        engines.append(eng)
    assert "attn_w_q" in engines[0].params["decoder"]["blocks"]
    got, want = engines[0].infer(str(tmp_path)).to_api_dict(), \
        jax_engine.infer(str(tmp_path)).to_api_dict()
    assert got == want
    video = engines[0].load_video(str(tmp_path))
    for a, b in zip(engines[0].request_ids(video), engines[1].request_ids(video)):
        np.testing.assert_array_equal(a, b)
