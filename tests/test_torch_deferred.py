"""The port's deferred-cache-write decode configuration
(``compile.deferred_decode_cache_write`` -> GPT2Config.deferred_cache_write)
against the JAX package on the CPU, driven as
tests/test_deferred_cache_write.py drives the JAX side: the deferred mode of
the beam-attention plain version against ``gpt2._beam_attend`` and against
the Pallas kernel in interpret mode, ``_attend_deferred`` against JAX's, and
greedy, beam-3 and beam-4 tokens and the engine's result with the switch.
Inputs are made with numpy from a seed; everything is f32 at tiny geometry."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from video_caption_tpu.config import default_inference_config as jax_default_config
from video_caption_tpu.decode import generate as jgen
from video_caption_tpu.engine import InferenceEngine as JaxEngine
from video_caption_tpu.models import gpt2 as jg2
from video_caption_tpu.ops.pallas import beam_attention as jba
from video_caption_tpu_torch.config import default_inference_config
from video_caption_tpu_torch.decode import generate as gen
from video_caption_tpu_torch.engine import InferenceEngine, model_config_from_inference
from video_caption_tpu_torch.models import caption_model as cm
from video_caption_tpu_torch.models import gpt2 as g2
from video_caption_tpu_torch.models import vit as vt
from video_caption_tpu_torch.models.convert import params_from_jax_numpy
from video_caption_tpu_torch.ops import beam_attention as ba


def port_cfg(jcfg, deferred=False):
    v, g = jcfg.vit, jcfg.gpt2
    return cm.CaptionModelConfig(
        vit=vt.ViTConfig(image_size=v.image_size, patch_size=v.patch_size,
                         embed_dim=v.embed_dim, depth=v.depth, num_heads=v.num_heads,
                         out_dim=v.out_dim, dtype=torch.float32),
        gpt2=g2.GPT2Config(vocab_size=g.vocab_size,
                           max_position_embeddings=g.max_position_embeddings,
                           n_embd=g.n_embd, n_layer=g.n_layer, n_head=g.n_head,
                           dtype=torch.float32, deferred_cache_write=deferred),
        prefix_len=jcfg.prefix_len, video_dim=jcfg.video_dim)


@pytest.fixture(scope="module")
def decoders(tiny_cfg, tiny_params):
    cfg = port_cfg(tiny_cfg)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, tiny_params), cfg, "cpu")
    return tiny_params["decoder"], tiny_cfg.gpt2, tp["decoder"], cfg.gpt2


def beam_case(b=2, k=3, nh=2, s0=7, n=6, seed=0):
    """Seeded inputs of one layer of a beam step (head dim 64): q, k_new,
    v_new [R, H], gkv [N, 2, R, H], pk/pv [B, S0, H], valid [B, S0] with a
    left-padded first video, anc [R, N] rows of the row's own video."""
    rng = np.random.RandomState(seed)
    h, r = nh * 64, b * k
    q, k_new, v_new = (rng.randn(r, h).astype(np.float32) for _ in range(3))
    gkv = rng.randn(n, 2, r, h).astype(np.float32)
    pk = rng.randn(b, s0, h).astype(np.float32)
    pv = rng.randn(b, s0, h).astype(np.float32)
    valid = np.ones((b, s0), np.int32)
    valid[0, : s0 // 3] = 0
    anc = (np.arange(r)[:, None] // k * k + rng.randint(0, k, (r, n))).astype(np.int32)
    return q, k_new, v_new, gkv, pk, pv, valid, anc


def _port_beam(case, t, k, nh, deferred=True):
    q, k_new, v_new, gkv, pk, pv, valid, anc = map(torch.from_numpy, case)
    extra = dict(k_new=k_new, v_new=v_new) if deferred else {}
    return ba.beam_attention_ref(q, gkv, pk, pv, valid, anc, t, k, nh, **extra).numpy()


def _jax_beam_attend(case, t, k, nh, deferred=True):
    q, k_new, v_new, gkv, pk, pv, valid, anc = map(jnp.asarray, case)
    b = valid.shape[0]
    cfg = jg2.GPT2Config(vocab_size=128, n_embd=q.shape[1], n_layer=1, n_head=nh,
                         dtype=jnp.float32)
    sel = jg2.ancestry_mask(anc, b, k, jnp.int32(t - 1 if deferred else t))
    extra = dict(k_new=k_new, v_new=v_new) if deferred else {}
    return np.asarray(jg2._beam_attend(q, pk, pv, gkv[:, 0], gkv[:, 1], valid, sel,
                                       jg2.head_block_mask(cfg), k, cfg, **extra))


@pytest.mark.parametrize("b,k,t", [(2, 3, 0), (2, 3, 3), (2, 3, 5), (1, 4, 0), (1, 4, 5)])
def test_deferred_plain_version_matches_jax_beam_attend(b, k, t):
    case = beam_case(b=b, k=k, seed=t)
    np.testing.assert_allclose(_port_beam(case, t, k, 2), _jax_beam_attend(case, t, k, 2),
                               atol=1e-5)


@pytest.mark.parametrize("t", [0, 2, 5])
def test_deferred_plain_version_matches_pallas_kernel(t):
    """The Pallas kernel in interpret mode needs (videos of a block x K) % 8
    == 0: 8 videos x 3 beams."""
    q, k_new, v_new, gkv, pk, pv, valid, anc = case = beam_case(b=8, k=3, seed=10 + t)
    cfg = jg2.GPT2Config(vocab_size=128, n_embd=128, n_layer=1, n_head=2, dtype=jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jba.beam_gen_attention(
            jnp.asarray(q), jnp.asarray(gkv)[None], jnp.asarray(pk)[None],
            jnp.asarray(pv)[None], jnp.asarray(valid), jnp.asarray(anc), jnp.int32(t),
            jg2.head_block_mask(cfg).astype(jnp.float32), 0, 3, 2,
            k_new=jnp.asarray(k_new), v_new=jnp.asarray(v_new))
    assert want is not None, jba.last_error
    np.testing.assert_allclose(_port_beam(case, t, 3, 2), np.asarray(want), atol=1e-5)


def test_deferred_mode_equals_the_written_cache():
    """Deferred at step t with k_new/v_new equals the other mode with those
    K/V written at column t (the self column is the ancestor column t:
    anc[:, t] is the identity)."""
    q, k_new, v_new, gkv, pk, pv, valid, anc = beam_case(seed=3)
    t = 4
    anc[:, t] = np.arange(anc.shape[0])
    written = gkv.copy()
    written[t, 0], written[t, 1] = k_new, v_new
    stale = (q, k_new, v_new, gkv, pk, pv, valid, anc)
    np.testing.assert_allclose(
        _port_beam(stale, t, 3, 2),
        _port_beam((q, k_new, v_new, written, pk, pv, valid, anc), t, 3, 2, deferred=False),
        atol=1e-5)


def test_wrapper_takes_k_new_and_v_new_together():
    q, k_new, v_new, gkv, pk, pv, valid, anc = map(torch.from_numpy, beam_case())
    with pytest.raises(ValueError, match="together"):
        ba.beam_attention(q, gkv, pk, pv, valid, anc, 2, 3, 2, k_new=k_new)
    with pytest.raises(ValueError, match="together"):
        ba.beam_attention(q, gkv, pk, pv, valid, anc, 2, 3, 2, v_new=v_new)


@pytest.mark.parametrize("offset", [5, 9])
def test_attend_deferred_matches_jax(offset):
    rng = np.random.RandomState(offset)
    b, max_len, nh, hd = 2, 12, 2, 32
    h = nh * hd
    q, k_new, v_new = (rng.randn(b, 1, nh, hd).astype(np.float32) for _ in range(3))
    kc, vc = (rng.randn(b, max_len, nh, hd).astype(np.float32) for _ in range(2))
    valid = np.zeros((b, max_len), np.int32)
    valid[:, :offset + 1] = 1
    valid[1, :2] = 0
    proj_w = (rng.randn(h, h) * 0.1).astype(np.float32)
    proj_b = (rng.randn(h) * 0.1).astype(np.float32)
    jcfg = jg2.GPT2Config(vocab_size=64, n_embd=h, n_layer=1, n_head=nh, dtype=jnp.float32)
    want = jg2._attend_deferred(*map(jnp.asarray, (q, kc, vc, k_new, v_new)),
                                {"proj_w": jnp.asarray(proj_w), "proj_b": jnp.asarray(proj_b)},
                                jnp.int32(offset), jnp.asarray(valid), jcfg)
    cfg = g2.GPT2Config(vocab_size=64, n_embd=h, n_layer=1, n_head=nh, dtype=torch.float32)
    got = g2._attend_deferred(*map(torch.from_numpy, (q, kc, vc, k_new, v_new)), offset,
                              torch.from_numpy(valid), cfg)
    got = got @ torch.from_numpy(proj_w) + torch.from_numpy(proj_b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _prompts(h, seed=0):
    rng = np.random.RandomState(seed)
    prefix = (rng.randn(2, 4, h) * 0.1).astype(np.float32)
    ids = np.array([[127, 127, 127, 5, 6], [7, 8, 9, 10, 11]], np.int32)
    return prefix, ids, (ids != 127).astype(np.int32)


@pytest.mark.parametrize("beams", [1, 3, 4])
def test_deferred_tokens_match_jax_and_the_default_path(decoders, beams):
    jd, jg, td, tg = decoders
    prefix, ids, mask = _prompts(tg.n_embd)
    kw = dict(max_new_tokens=8, num_beams=beams, temperature=1.0, min_new_tokens=2, eos_id=127)
    want = np.asarray(jgen.generate_prefixed(
        jd, dataclasses.replace(jg, deferred_cache_write=True), jnp.asarray(prefix),
        jnp.asarray(ids), jnp.asarray(mask), jgen.DecodeParams(**kw)))
    args = (torch.from_numpy(prefix), torch.from_numpy(ids), torch.from_numpy(mask),
            gen.DecodeParams(**kw))
    got = gen.generate_prefixed(td, dataclasses.replace(tg, deferred_cache_write=True), *args)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), gen.generate_prefixed(td, tg, *args).numpy())


def test_deferred_sampled_tokens_match_the_default_path(decoders):
    """JAX and torch random streams cannot match; with one torch.Generator
    seed the switch must not change a sampled token."""
    _, _, td, tg = decoders
    prefix, ids, mask = _prompts(tg.n_embd, seed=1)
    dp = gen.DecodeParams(max_new_tokens=8, num_beams=1, temperature=0.9, top_k=5, top_p=0.9,
                          min_new_tokens=2, eos_id=127)

    def run(cfg):
        return gen.generate_prefixed(td, cfg, torch.from_numpy(prefix), torch.from_numpy(ids),
                                     torch.from_numpy(mask), dp,
                                     torch.Generator().manual_seed(5)).numpy()

    np.testing.assert_array_equal(run(dataclasses.replace(tg, deferred_cache_write=True)),
                                  run(tg))


def _forward_steps(td, cfg, steps=3):
    """Prefill then ``steps`` K=1 steps over the contiguous cache; (logits of
    each step, the cache)."""
    b, s0 = 2, 4
    emb = torch.from_numpy(np.random.RandomState(2).randn(b, s0, cfg.n_embd)
                           .astype(np.float32) * 0.1)
    cache = g2.init_cache(cfg, b, s0 + steps, "cpu")
    valid = torch.zeros((b, s0 + steps), dtype=torch.int32)
    valid[:, :s0] = 1
    pos = torch.arange(s0)[None].expand(b, s0)
    logits, cache = g2.gpt2_forward(td, emb, pos, valid, cache, 0, cfg)
    out = []
    for t in range(steps):
        valid[:, s0 + t] = 1
        tok = logits[:, -1].argmax(-1)
        logits, cache = g2.gpt2_forward(td, td["wte"][tok][:, None], torch.full((b, 1), s0 + t),
                                        valid, cache, s0 + t, cfg)
        out.append(logits)
    return torch.stack(out), cache["kv"]


def test_deferred_forward_writes_the_same_cache(decoders):
    """One store after the layer loop lands the values of the per-layer
    writes (f32 rounding: the self column sits last in the softmax sum)."""
    _, _, td, tg = decoders
    logits, kv = _forward_steps(td, tg)
    logits_d, kv_d = _forward_steps(td, dataclasses.replace(tg, deferred_cache_write=True))
    torch.testing.assert_close(kv_d, kv, atol=1e-6, rtol=0)
    torch.testing.assert_close(logits_d, logits, atol=1e-5, rtol=1e-5)


def test_deferred_takes_precedence_over_decode_attention(decoders, monkeypatch):
    """With use_pallas_decode set too, the K=1 step takes _attend_deferred,
    as in the JAX package: the decode-attention op is never reached."""
    _, _, td, tg = decoders
    calls = []
    monkeypatch.setattr(g2, "decode_attention", lambda *a: calls.append("decode_attention"))
    cfg = dataclasses.replace(tg, deferred_cache_write=True, use_pallas_decode=True)
    logits, _ = _forward_steps(td, cfg)
    assert calls == []
    torch.testing.assert_close(logits, _forward_steps(td, tg)[0], atol=1e-5, rtol=1e-5)


def test_decode_layer_takes_precedence_over_deferred(decoders, monkeypatch):
    """The flat cache (decode_layer) comes before deferred, as in the JAX
    package."""
    _, _, td, tg = decoders
    calls = []
    real = g2.gpt2_decode_step
    monkeypatch.setattr(g2, "_attend_deferred", lambda *a: calls.append("deferred"))
    monkeypatch.setattr(g2, "gpt2_decode_step",
                        lambda *a, **k: calls.append("layer") or real(*a, **k))
    cfg = dataclasses.replace(tg, deferred_cache_write=True, use_pallas_decode_layer=True)
    prefix, ids, mask = _prompts(tg.n_embd)
    gen.generate_prefixed(td, cfg, torch.from_numpy(prefix),
                          torch.from_numpy(ids), torch.from_numpy(mask),
                          gen.DecodeParams(max_new_tokens=4, min_new_tokens=2, eos_id=127))
    assert calls == ["layer"] * 3


def test_deferred_beam_step_writes_once_after_the_layer_loop(decoders, monkeypatch):
    """The deferred beam step hands the kernel k_new/v_new in every layer and
    leaves column t of the generated cache to one store; it lands the
    values of the per-layer writes."""
    _, _, td, tg = decoders
    b, k, s0, n, t = 2, 3, 5, 4, 2
    r, h = b * k, tg.n_embd
    rng = np.random.RandomState(4)
    pcache = {name: torch.from_numpy(rng.randn(tg.n_layer, b, s0, h).astype(np.float32))
              for name in ("k", "v")}
    pvalid = torch.ones((b, s0), dtype=torch.int32)
    anc = torch.from_numpy((np.arange(r)[:, None] // k * k
                            + rng.randint(0, k, (r, n))).astype(np.int32))
    anc[:, t] = torch.arange(r, dtype=torch.int32)
    gkv0 = torch.from_numpy(rng.randn(tg.n_layer, n, 2, r, h).astype(np.float32))
    emb = torch.from_numpy(rng.randn(r, h).astype(np.float32) * 0.1)
    wte_t = g2.lm_head_t(td, tg)
    seen = []
    real = g2.beam_attention
    monkeypatch.setattr(g2, "beam_attention",
                        lambda *a, **kw: seen.append(sorted(kw)) or real(*a, **kw))
    outs = {}
    for deferred in (False, True):
        cfg = dataclasses.replace(tg, deferred_cache_write=deferred)
        gkv = {"kv": gkv0.clone()}
        stats, gkv = g2.gpt2_beam_step(td, emb, torch.full((r,), s0 + t), pcache, pvalid, gkv,
                                       anc, t, k, cfg, wte_t)
        outs[deferred] = (stats[0], gkv["kv"])
    assert seen == [[]] * tg.n_layer + [["k_new", "v_new"]] * tg.n_layer
    torch.testing.assert_close(outs[True][1], outs[False][1], atol=1e-6, rtol=0)
    torch.testing.assert_close(outs[True][0], outs[False][0], atol=1e-5, rtol=1e-5)


def test_engine_passes_the_switch_through():
    base = default_inference_config()
    assert not base.compile.deferred_decode_cache_write
    assert not model_config_from_inference(base).gpt2.deferred_cache_write
    on = dataclasses.replace(base, compile=dataclasses.replace(
        base.compile, deferred_decode_cache_write=True))
    assert model_config_from_inference(on).gpt2.deferred_cache_write


class WordTok:
    """Tiny-vocab tokenizer whose decodes are word strings the cleaner keeps."""
    eos_token_id = bos_token_id = pad_token_id = 127
    vocab_size = 128
    words = ("a man woman dog cat is are the on in with red blue small big runs walks "
             "plays sits holds ball car street park table water food girl boy").split()

    def encode(self, text):
        return [b % 127 for b in text.encode()] or [1]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(self.words[int(i) % len(self.words)] for i in ids if int(i) != 127)


def test_engine_with_the_switch_matches_jax_engine(tiny_cfg, tiny_params, tmp_path):
    from PIL import Image

    rng = np.random.RandomState(9)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(
            tmp_path / f"frame_{i:05d}.jpg")
    kw = dict(ckpt="missing.pt", num_frames=2, image_size=32, preset1="precise",
              preset2="detailed", preset3="precise", prompt3="Another prompt:")
    jcfg = jax_default_config(**kw)
    jcfg = dataclasses.replace(jcfg, compile=dataclasses.replace(
        jcfg.compile, deferred_decode_cache_write=True))
    jmodel = dataclasses.replace(tiny_cfg, gpt2=dataclasses.replace(
        tiny_cfg.gpt2, deferred_cache_write=True))
    jax_engine = JaxEngine(jcfg, params=tiny_params, model_cfg=jmodel)
    cfg = default_inference_config(**kw)
    cfg = dataclasses.replace(cfg, compile=dataclasses.replace(
        cfg.compile, deferred_decode_cache_write=True))
    pcfg = port_cfg(tiny_cfg, deferred=True)
    port = InferenceEngine(cfg, params=params_from_jax_numpy(
        jax.tree.map(np.asarray, tiny_params), pcfg, "cpu"), model_cfg=pcfg, device="cpu")
    jax_engine.tokenizer = port.tokenizer = WordTok()
    want = jax_engine.infer(str(tmp_path)).to_api_dict()
    got = port.infer(str(tmp_path)).to_api_dict()
    assert got == want
    assert got["S1"] != "Someone is in the scene."   # the comparison is not vacuous
