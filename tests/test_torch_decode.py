"""The port's decode stack (video_caption_tpu_torch/decode) against the JAX
package on the same weights: greedy, beam-3 and beam-4 tokens must be
identical with left-padded prompts; a sampled step must pick the same token
given the same Gumbel noise; the warpers must agree elementwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_caption_tpu.decode import generate as jgen
from video_caption_tpu.decode import logits_process as jlp
from video_caption_tpu_torch.decode import generate as gen
from video_caption_tpu_torch.decode import logits_process as lp
from video_caption_tpu_torch.models import caption_model as cm
from video_caption_tpu_torch.models import gpt2 as g2
from video_caption_tpu_torch.models import vit as vt
from video_caption_tpu_torch.models.convert import params_from_jax_numpy


def port_cfg(jcfg, dtype=torch.float32):
    v, g = jcfg.vit, jcfg.gpt2
    return cm.CaptionModelConfig(
        vit=vt.ViTConfig(image_size=v.image_size, patch_size=v.patch_size,
                         embed_dim=v.embed_dim, depth=v.depth, num_heads=v.num_heads,
                         out_dim=v.out_dim, dtype=dtype),
        gpt2=g2.GPT2Config(vocab_size=g.vocab_size,
                           max_position_embeddings=g.max_position_embeddings,
                           n_embd=g.n_embd, n_layer=g.n_layer, n_head=g.n_head, dtype=dtype),
        prefix_len=jcfg.prefix_len, video_dim=jcfg.video_dim)


@pytest.fixture(scope="module")
def decoders(tiny_cfg, tiny_params):
    cfg = port_cfg(tiny_cfg)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, tiny_params), cfg, "cpu")
    return tiny_params["decoder"], tiny_cfg.gpt2, tp["decoder"], cfg.gpt2


def _prompts(h):
    """Two rows with prompts of different lengths, LEFT-padded (pad id 127)."""
    rng = np.random.RandomState(0)
    prefix = (rng.randn(2, 4, h) * 0.1).astype(np.float32)
    ids = np.array([[127, 127, 127, 5, 6], [7, 8, 9, 10, 11]], np.int32)
    mask = (ids != 127).astype(np.int32)
    return prefix, ids, mask


@pytest.mark.parametrize("beams", [1, 3, 4])
def test_generate_prefixed_tokens_match_jax(decoders, beams):
    jd, jg, td, tg = decoders
    prefix, ids, mask = _prompts(tg.n_embd)
    kw = dict(max_new_tokens=8, num_beams=beams, temperature=1.0, min_new_tokens=2, eos_id=127)
    want = np.asarray(jgen.generate_prefixed(jd, jg, jnp.asarray(prefix), jnp.asarray(ids),
                                             jnp.asarray(mask), jgen.DecodeParams(**kw)))
    got = gen.generate_prefixed(td, tg, torch.from_numpy(prefix), torch.from_numpy(ids),
                                torch.from_numpy(mask), gen.DecodeParams(**kw)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("beams", [1, 3])
def test_padded_row_decodes_like_unpadded(decoders, beams):
    """Left padding is observation-equivalent to decoding a row alone."""
    _, _, td, tg = decoders
    prefix, ids, mask = _prompts(tg.n_embd)
    dp = gen.DecodeParams(max_new_tokens=6, num_beams=beams, min_new_tokens=2, eos_id=127)
    both = gen.generate_prefixed(td, tg, torch.from_numpy(prefix), torch.from_numpy(ids),
                                 torch.from_numpy(mask), dp)
    alone = gen.generate_prefixed(td, tg, torch.from_numpy(prefix[:1]),
                                  torch.from_numpy(ids[:1, 3:]), torch.from_numpy(mask[:1, 3:]), dp)
    np.testing.assert_array_equal(both[:1].numpy(), alone.numpy())


def _stats_case(seed=0, b=3, v=1000, n=8):
    rng = np.random.RandomState(seed)
    vp = -(-v // 128) * 128
    logits = rng.randn(b, vp).astype(np.float32) * 3
    logits[:, v:] = -np.inf
    wmax = logits.reshape(b, -1, 128).max(-1)
    generated = rng.randint(0, 20, (b, n)).astype(np.int32)
    logits[:, :20] += 4.0       # make the generated tokens competitive
    wmax = logits.reshape(b, -1, 128).max(-1)
    return logits, wmax, generated


@pytest.mark.parametrize("t", [0, 3, 6])
def test_sample_select_same_noise_same_token(t):
    logits, wmax, generated = _stats_case(seed=t)
    dp_kw = dict(num_beams=1, temperature=0.9, top_p=0.9, top_k=50, repetition_penalty=1.05,
                 no_repeat_ngram_size=3, min_new_tokens=8, eos_id=999)
    jdp, dp = jgen.DecodeParams(**dp_kw), gen.DecodeParams(**dp_kw)
    rng = jax.random.PRNGKey(t)
    _, sub = jax.random.split(rng)                          # the split sample_select makes
    noise = np.array(jax.random.gumbel(sub, (3, 50), jnp.float32))
    finished = np.array([False, False, True])
    jtok, jgen_ids, jfin, _ = jgen.sample_select(
        jnp.asarray(logits), jnp.asarray(generated), jnp.asarray(finished), jnp.int32(t), jdp,
        rng, wmax=jnp.asarray(wmax))
    tok, gen_ids, fin = gen.sample_select(
        torch.from_numpy(logits), torch.from_numpy(generated.astype(np.int64)),
        torch.from_numpy(finished), t, dp, None, wmax=torch.from_numpy(wmax),
        noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(gen_ids.numpy(), np.asarray(jgen_ids))
    np.testing.assert_array_equal(fin.numpy(), np.asarray(jfin))


@pytest.mark.parametrize("t", [0, 5])
def test_candidate_warpers_match_jax_elementwise(t):
    logits, wmax, generated = _stats_case(seed=10 + t)
    args = (t, 50, 1.05, 3, 8, 999)
    jv, ji = jlp.topk_processed(jnp.asarray(logits), jnp.asarray(generated), jnp.int32(t),
                                *args[1:], wmax=jnp.asarray(wmax))
    tv, ti = lp.topk_processed(torch.from_numpy(logits), torch.from_numpy(generated), *args,
                               wmax=torch.from_numpy(wmax))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    jt = jlp.apply_temperature(jv, 0.9)
    tt = lp.apply_temperature(tv, 0.9)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
    # nucleus mask of sample_sorted_top_p (the part before the draw)
    lse = jax.nn.logsumexp(jt, axis=-1, keepdims=True)
    probs = jnp.exp(jt - lse)
    keep = (jnp.cumsum(probs, axis=-1) - probs) < 0.9
    np.testing.assert_array_equal(np.isfinite(lp.top_p_filter(tt, 0.9).numpy()),
                                  np.asarray(keep & jnp.isfinite(jt)))


@pytest.mark.parametrize("k", [1, 6, 60])
def test_exact_topk_with_window_maxima(k):
    logits, wmax, _ = _stats_case(seed=20)
    tv, ti = lp.exact_topk(torch.from_numpy(logits), k, wmax=torch.from_numpy(wmax))
    jv, ji = jax.lax.top_k(jnp.asarray(logits), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("t", [0, 2, 4, 7])
def test_ngram_bans_match_jax(t):
    generated = np.array([[1, 2, 3, 1, 2, 3, 1, 2], [4, 4, 4, 4, 5, 5, 5, 5]], np.int32)
    jb, jm = jlp._ngram_banned(jnp.asarray(generated), jnp.int32(t), 3)
    tb, tm = lp.ngram_banned(torch.from_numpy(generated), t, 3)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_stable_top_k_orders_ties_like_lax():
    x = np.array([[1.0, 3.0, 3.0, -np.inf, 3.0, -np.inf]], np.float32)
    tv, ti = lp._top_k(torch.from_numpy(x), 6)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_unported_policy_raises():
    """The policy this test once saw refused (repetition_penalty 0.9, which
    raises seen scores and breaks the candidate bound) now takes the
    full-vocab chain and selects the tokens the JAX package selects."""
    logits, wmax, generated = _stats_case()
    kw = dict(num_beams=1, repetition_penalty=0.9, eos_id=999)
    finished = np.array([False, True, False])
    for t in (0, 5):
        jtok, jgen_ids, jfin, _ = jgen.sample_select(
            jnp.asarray(logits), jnp.asarray(generated), jnp.asarray(finished), jnp.int32(t),
            jgen.DecodeParams(**kw), jax.random.PRNGKey(0), wmax=jnp.asarray(wmax))
        tok, gen_ids, fin = gen.sample_select(
            torch.from_numpy(logits), torch.from_numpy(generated.astype(np.int64)),
            torch.from_numpy(finished), t, gen.DecodeParams(**kw), None,
            wmax=torch.from_numpy(wmax))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(gen_ids.numpy(), np.asarray(jgen_ids))
        np.testing.assert_array_equal(fin.numpy(), np.asarray(jfin))


def test_decode_params_rule_matches_jax():
    for kw in (dict(), dict(num_beams=3), dict(temperature=0.9), dict(num_beams=3, temperature=0.9)):
        assert gen.DecodeParams(**kw).do_sample == jgen.DecodeParams(**kw).do_sample
    import dataclasses

    assert [f.name for f in dataclasses.fields(gen.DecodeParams)] == \
        [f.name for f in dataclasses.fields(jgen.DecodeParams)]
