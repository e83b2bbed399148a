"""The port's fused K=1 decode configurations against the JAX package on the
CPU: the plain versions of the decode-attention and decode-layer kernels
against the Pallas kernels (run in interpret mode, as tests/test_pallas_ops.py
runs them), the flat ``kvf`` prefill layout, and greedy/sampled tokens with
``use_pallas_decode`` / ``use_pallas_decode_layer``. Inputs are made with
numpy from a seed; everything is f32 at the conftest's tiny geometry."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from video_caption_tpu.decode import generate as jgen
from video_caption_tpu.models import gpt2 as jg2
from video_caption_tpu.ops.pallas import decode_attention as jda
from video_caption_tpu.ops.pallas import decode_layer as jdl
from video_caption_tpu_torch.config import default_inference_config
from video_caption_tpu_torch.decode import generate as gen
from video_caption_tpu_torch.engine import InferenceEngine, model_config_from_inference
from video_caption_tpu_torch.models import caption_model as cm
from video_caption_tpu_torch.models import gpt2 as g2
from video_caption_tpu_torch.models import vit as vt
from video_caption_tpu_torch.models.convert import params_from_jax_numpy
from video_caption_tpu_torch.ops import decode_attention as da
from video_caption_tpu_torch.ops import decode_layer as dl

SWITCHES = ("use_pallas_decode", "use_pallas_decode_layer")


def port_cfg(jcfg):
    v, g = jcfg.vit, jcfg.gpt2
    return cm.CaptionModelConfig(
        vit=vt.ViTConfig(image_size=v.image_size, patch_size=v.patch_size,
                         embed_dim=v.embed_dim, depth=v.depth, num_heads=v.num_heads,
                         out_dim=v.out_dim, dtype=torch.float32),
        gpt2=g2.GPT2Config(vocab_size=g.vocab_size,
                           max_position_embeddings=g.max_position_embeddings,
                           n_embd=g.n_embd, n_layer=g.n_layer, n_head=g.n_head,
                           dtype=torch.float32),
        prefix_len=jcfg.prefix_len, video_dim=jcfg.video_dim)


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture(scope="module")
def decoders(tiny_cfg, tiny_params):
    cfg = port_cfg(tiny_cfg)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, tiny_params), cfg, "cpu")
    return tiny_params["decoder"], tiny_cfg.gpt2, tp["decoder"], cfg.gpt2


def _attention_case(seed=0, b=2, l=16, nh=4, hd=64, masked=6):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, nh, hd).astype(np.float32)
    k = rng.randn(b, l, nh, hd).astype(np.float32)
    v = rng.randn(b, l, nh, hd).astype(np.float32)
    valid = np.ones((b, l), np.int32)
    valid[:, l - masked:] = 0
    return q, k, v, valid


@pytest.mark.parametrize("layout", ["separate", "interleaved"])
def test_decode_attention_plain_matches_pallas(layout):
    q, k, v, valid = _attention_case()
    want = np.asarray(jda.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(valid)))
    assert jda.last_backend == "pallas"
    if layout == "separate":
        kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    else:   # K and V as strided views of one interleaved [B, L, 2, nh, hd] cache layer
        kv = torch.from_numpy(np.stack([k, v], axis=2))
        kt, vt = kv[:, :, 0], kv[:, :, 1]
    got = da.decode_attention(torch.from_numpy(q), kt, vt, torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_decode_attention_keeps_probabilities_in_f32():
    """Unlike the XLA attention, the kernel does not round the probabilities
    to the compute dtype: with bf16 inputs the plain version equals the f32
    computation rounded once at the end."""
    q, k, v, valid = (torch.from_numpy(a) for a in _attention_case(seed=1))
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    got = da.decode_attention_ref(qb, kb, vb, valid)
    want = da.decode_attention_ref(qb.float(), kb.float(), vb.float(), valid).bfloat16()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def _step_case(cfg, seed, b=2, max_len=12):
    rng = np.random.RandomState(seed)
    h, n_layer = cfg.n_embd, cfg.n_layer

    def nrm(*shape, std=0.2):
        return (rng.randn(*shape) * std).astype(np.float32)

    blocks = {
        "ln1_scale": 1 + nrm(n_layer, h, std=0.1), "ln1_bias": nrm(n_layer, h, std=0.1),
        "attn_w": nrm(n_layer, h, 3 * h), "attn_b": nrm(n_layer, 3 * h, std=0.1),
        "proj_w": nrm(n_layer, h, h), "proj_b": nrm(n_layer, h, std=0.1),
        "ln2_scale": 1 + nrm(n_layer, h, std=0.1), "ln2_bias": nrm(n_layer, h, std=0.1),
        "fc_w": nrm(n_layer, h, 4 * h), "fc_b": nrm(n_layer, 4 * h, std=0.1),
        "out_w": nrm(n_layer, 4 * h, h), "out_b": nrm(n_layer, h, std=0.1),
    }
    x = nrm(b, h, std=1.0)
    kvf = nrm(n_layer, max_len, b, 2 * h, std=1.0)
    valid = np.ones((b, max_len), np.int32)
    valid[0, :3] = 0                      # a left-padded first row
    valid[1, 5] = 0
    return x, kvf, valid, blocks


@pytest.mark.parametrize("offset", [0, 7, 11])
def test_decode_step_plain_matches_pallas(decoders, offset):
    _, jg, _, tg = decoders
    x, kvf, valid, blocks = _step_case(tg, seed=offset)
    valid[:, offset + 1:] = 0             # the caller marks columns up to the step's own
    valid[:, offset] = 1
    jx, jkvf = jdl.gpt2_decode_step(jnp.asarray(x), jnp.asarray(kvf), jnp.asarray(valid),
                                    jnp.int32(offset), jax.tree.map(jnp.asarray, blocks),
                                    jg.n_head, jg.ln_eps)
    tkvf = torch.from_numpy(kvf.copy())
    tx, out_kvf = dl.gpt2_decode_step(torch.from_numpy(x), tkvf, torch.from_numpy(valid), offset,
                                      {k: torch.from_numpy(v) for k, v in blocks.items()},
                                      tg.n_head, tg.ln_eps)
    assert out_kvf is tkvf                # written in place
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tkvf.numpy(), np.asarray(jkvf), atol=1e-5, rtol=1e-5)
    untouched = np.arange(kvf.shape[1]) != offset
    np.testing.assert_array_equal(tkvf.numpy()[:, untouched], kvf[:, untouched])


def _prefill_inputs(h, b=2, s0=5, seed=3):
    rng = np.random.RandomState(seed)
    emb = (rng.randn(b, s0, h) * 0.1).astype(np.float32)
    mask = np.ones((b, s0), np.int32)
    mask[0, :2] = 0
    return emb, mask


def test_kvf_prefill_layout(decoders):
    """The prefill into the flat cache is the contiguous prefill reshaped
    exactly as the JAX package reshapes it, and agrees with the JAX package's
    own flat-cache prefill."""
    jd, jg, td, tg = decoders
    emb, mask = _prefill_inputs(tg.n_embd)
    b, s0, _ = emb.shape
    max_len = s0 + 4
    valid = np.zeros((b, max_len), np.int32)
    valid[:, :s0] = mask
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0)
    kcfg = dataclasses.replace(tg, use_pallas_decode_layer=True)
    args = (torch.from_numpy(emb), torch.from_numpy(pos), torch.from_numpy(valid))
    flat = g2.init_cache(kcfg, b, max_len, "cpu")
    contiguous = g2.init_cache(tg, b, max_len, "cpu")
    assert set(flat) == {"kvf"} and set(contiguous) == {"kv"}
    out_flat, flat = g2.gpt2_forward(td, *args, flat, 0, kcfg)
    out_contig, contiguous = g2.gpt2_forward(td, *args, contiguous, 0, tg)
    torch.testing.assert_close(out_flat, out_contig, atol=0, rtol=0)
    jax_layout = jnp.asarray(contiguous["kv"].numpy()).reshape(
        tg.n_layer, b, max_len, 2 * tg.n_embd).transpose(0, 2, 1, 3)
    np.testing.assert_array_equal(flat["kvf"].numpy(), np.asarray(jax_layout))

    jkcfg = dataclasses.replace(jg, use_pallas_decode_layer=True)
    jcache = jg2.init_cache(jkcfg, b, max_len)
    assert set(jcache) == {"kvf"}
    _, jcache = jg2.gpt2_forward(jd, jnp.asarray(emb), jnp.asarray(pos), jnp.asarray(valid),
                                 jcache, jnp.int32(0), jkcfg)
    np.testing.assert_allclose(flat["kvf"].numpy(), np.asarray(jcache["kvf"]),
                               atol=1e-5, rtol=1e-5)


def _greedy(**kw):
    base = dict(max_new_tokens=6, num_beams=1, min_new_tokens=2, eos_id=127)
    base.update(kw)
    return base


@pytest.mark.parametrize("switch", SWITCHES)
def test_greedy_tokens_match_jax_with_switch(decoders, switch):
    jd, jg, td, tg = decoders
    emb, mask = _prefill_inputs(tg.n_embd, seed=5)
    want = np.asarray(jgen.generate(jd, dataclasses.replace(jg, **{switch: True}),
                                    jnp.asarray(emb), jgen.DecodeParams(**_greedy()),
                                    prefill_mask=jnp.asarray(mask)))
    got = gen.greedy_or_sample(td, dataclasses.replace(tg, **{switch: True}),
                               torch.from_numpy(emb), gen.DecodeParams(**_greedy()),
                               prefill_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    base = gen.greedy_or_sample(td, tg, torch.from_numpy(emb), gen.DecodeParams(**_greedy()),
                                prefill_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, base)


@pytest.mark.parametrize("switch", SWITCHES + ("both",))
def test_sampled_tokens_match_default_path(decoders, switch):
    """JAX and torch random streams cannot match; with one torch.Generator
    seed, a switch must not change a sampled token."""
    _, _, td, tg = decoders
    emb, mask = _prefill_inputs(tg.n_embd, seed=6)
    dp = gen.DecodeParams(**_greedy(temperature=0.9, top_k=5, top_p=0.9, max_new_tokens=8))
    flags = dict.fromkeys(SWITCHES if switch == "both" else (switch,), True)

    def run(cfg):
        return gen.greedy_or_sample(td, cfg, torch.from_numpy(emb), dp,
                                    torch.Generator().manual_seed(11),
                                    prefill_mask=torch.from_numpy(mask)).numpy()

    np.testing.assert_array_equal(run(dataclasses.replace(tg, **flags)), run(tg))


def test_both_switches_take_the_flat_cache(decoders, monkeypatch):
    """With both switches set the decode-layer step takes the decode, as in
    the JAX package: the decode-attention op is never reached."""
    _, _, td, tg = decoders
    cfg = dataclasses.replace(tg, use_pallas_decode=True, use_pallas_decode_layer=True)
    assert set(g2.init_cache(cfg, 1, 4, "cpu")) == {"kvf"}
    calls = []
    real = g2.gpt2_decode_step
    monkeypatch.setattr(g2, "decode_attention", lambda *a: calls.append("attention"))
    monkeypatch.setattr(g2, "gpt2_decode_step",
                        lambda *a, **k: calls.append("layer") or real(*a, **k))
    emb, mask = _prefill_inputs(tg.n_embd, seed=7)
    gen.greedy_or_sample(td, cfg, torch.from_numpy(emb), gen.DecodeParams(**_greedy()),
                         prefill_mask=torch.from_numpy(mask))
    assert calls == ["layer"] * 5


def test_prepare_decode_params_dtypes(decoders):
    _, _, td, tg = decoders
    bf = dataclasses.replace(tg, dtype=torch.bfloat16)
    prepared = g2.prepare_decode_params(td, bf)
    for name, t in prepared["blocks"].items():
        assert t.dtype == (torch.float32 if name.startswith("ln") else torch.bfloat16), name
    assert prepared["wte"] is td["wte"]


def test_engine_passes_the_switches_through():
    base = default_inference_config()
    assert not base.compile.use_pallas_decode_attention
    assert not base.compile.use_pallas_decode_layer
    off = model_config_from_inference(base).gpt2
    assert not (off.use_pallas_decode or off.use_pallas_decode_layer)
    on = model_config_from_inference(dataclasses.replace(base, compile=dataclasses.replace(
        base.compile, use_pallas_decode_attention=True, use_pallas_decode_layer=True))).gpt2
    assert on.use_pallas_decode and on.use_pallas_decode_layer


class _ByteTok:
    """Tiny-vocab tokenizer: bytes folded into the 128-token test vocab."""
    eos_token_id = bos_token_id = pad_token_id = 127

    def encode(self, text):
        return [b % 127 for b in text.encode()] or [1]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{int(i)}" for i in ids if int(i) != 127)


@pytest.mark.parametrize("compile_switch", ["use_pallas_decode_attention",
                                            "use_pallas_decode_layer"])
def test_engine_presets_unchanged_by_switch(tiny_cfg, tiny_params, compile_switch):
    """The whole decode slice through the engine: the core presets (beam
    and sampled groups, left-padded prompts) give the same texts with a
    switch on as with it off, for the same seed."""
    pcfg = port_cfg(tiny_cfg)
    params = params_from_jax_numpy(jax.tree.map(np.asarray, tiny_params), pcfg, "cpu")
    base = default_inference_config(ckpt="missing.pt", num_frames=2, image_size=32)
    on = dataclasses.replace(base, compile=dataclasses.replace(base.compile,
                                                               **{compile_switch: True}))
    prefix = torch.from_numpy(np.random.RandomState(8).randn(1, 4, pcfg.gpt2.n_embd)
                              .astype(np.float32) * 0.1)
    texts = []
    for cfg in (base, on):
        model_cfg = dataclasses.replace(pcfg, gpt2=dataclasses.replace(
            pcfg.gpt2, **{k: getattr(model_config_from_inference(cfg).gpt2, k)
                          for k in SWITCHES}))
        engine = InferenceEngine(cfg, params=params, model_cfg=model_cfg, seed=2, device="cpu")
        engine.tokenizer = _ByteTok()
        pairs = [(cfg.preset1, cfg.prompt1), (cfg.preset2, cfg.prompt2),
                 (cfg.preset3, cfg.prompt3)]
        texts.append(engine.generate_presets(prefix, pairs))
    assert texts[0] == texts[1]


def test_fused_decode_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    never sent to the plain version."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(torch.empty(2, 4, 64, **meta), torch.empty(2, 8, 4, 64, **meta),
                            torch.empty(2, 8, 4, 64, **meta),
                            torch.empty(2, 8, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        dl.gpt2_decode_step(torch.empty(1, 64, **meta), torch.empty(1, 4, 1, 128, **meta),
                            torch.empty(1, 4, dtype=torch.int32, **meta), 0, {}, 1)
