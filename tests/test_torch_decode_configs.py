"""The decode configurations the port gained beside the default: early stop,
the split-cache K=1 step, and the full-vocab processor chain (a repetition
penalty below 1, sampling with top_k = 0), against the JAX package on the
CPU at the conftest's tiny geometry in f32, and through the unified decode
and the engine.

Tolerances: greedy and beam ids identical; every processed-logits function
within 1e-5 of its JAX counterpart; the split-cache step's logits within
1e-5 of the JAX step's; sampled ids identical where both packages draw from
the same Gumbel noise, and by distribution otherwise (``top_k = 0``: the
empirical frequencies of 20,000 draws within 0.015 of the JAX package's
processed softmax, 5 standard deviations of the largest probability's
frequency, total variation below 0.03, nothing drawn outside its
support)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_aot import WordTok, port_cfg, port_params  # noqa: F401
from test_torch_unified import _prompts
from video_caption_tpu.config import default_inference_config as jax_default_config
from video_caption_tpu.decode import generate as jgen
from video_caption_tpu.decode import logits_process as jlp
from video_caption_tpu.engine import InferenceEngine as JaxEngine
from video_caption_tpu.models import gpt2 as jg2
from video_caption_tpu_torch.config import default_inference_config
from video_caption_tpu_torch.decode import generate as gen
from video_caption_tpu_torch.decode import logits_process as lp
from video_caption_tpu_torch.decode import unified
from video_caption_tpu_torch.engine import InferenceEngine
from video_caption_tpu_torch.models import gpt2 as g2

EOS = 127


@pytest.fixture(scope="module")
def decoders(tiny_cfg, tiny_params, port_params):  # noqa: F811
    return tiny_params["decoder"], tiny_cfg.gpt2, port_params["decoder"], \
        port_cfg(tiny_cfg).gpt2


def _inputs(h, seed=0):
    rng = np.random.RandomState(seed)
    prefix = (rng.randn(2, 4, h) * 0.1).astype(np.float32)
    ids = np.array([[EOS, EOS, EOS, 5, 6], [7, 8, 9, 10, 11]], np.int32)
    return prefix, ids, (ids != EOS).astype(np.int32)


def _jax_ids(decoders, kw, gpt2_kw=None, seed=0):
    jd, jg, _, tg = decoders
    prefix, ids, mask = _inputs(tg.n_embd, seed)
    jg = dataclasses.replace(jg, **(gpt2_kw or {}))
    return np.asarray(jgen.generate_prefixed(jd, jg, jnp.asarray(prefix), jnp.asarray(ids),
                                             jnp.asarray(mask), jgen.DecodeParams(**kw)))


def _port_ids(decoders, kw, gpt2_kw=None, seed=0, generator=None):
    _, _, td, tg = decoders
    prefix, ids, mask = _inputs(tg.n_embd, seed)
    tg = dataclasses.replace(tg, **(gpt2_kw or {}))
    return gen.generate_prefixed(td, tg, torch.from_numpy(prefix), torch.from_numpy(ids),
                                 torch.from_numpy(mask), gen.DecodeParams(**kw),
                                 generator).numpy()


# ---- early stop ----------------------------------------------------------


@pytest.mark.parametrize("beams", [1, 3, 5])
def test_early_stop_ids_match_jax_and_the_full_loop(decoders, beams):
    """Early stop against the JAX while_loop and the port's full-length
    loop; min_new_tokens 1 and a short horizon so the rows finish early."""
    kw = dict(max_new_tokens=10, num_beams=beams, min_new_tokens=1, eos_id=EOS,
              early_stop=True)
    got = _port_ids(decoders, kw)
    np.testing.assert_array_equal(got, _jax_ids(decoders, kw))
    np.testing.assert_array_equal(got, _port_ids(decoders, {**kw, "early_stop": False}))


def test_early_stop_ends_the_loop(decoders, monkeypatch):
    """The loop really ends early: a row set that finishes at its first
    token (EOS made the only candidate) runs no decode step at all."""
    calls = []
    real = g2.gpt2_forward
    monkeypatch.setattr(g2, "gpt2_forward", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    kw = dict(max_new_tokens=6, num_beams=1, min_new_tokens=0, eos_id=EOS,
              repetition_penalty=1.0, no_repeat_ngram_size=0)
    _, _, td, tg = decoders
    td = {**td, "lnf_scale": torch.zeros_like(td["lnf_scale"]),
          "lnf_bias": torch.zeros_like(td["lnf_bias"])}
    td["wte"] = td["wte"].clone()
    td["lnf_bias"][0] = 1.0
    td["wte"][EOS, 0] = 50.0                       # every logit row peaks at EOS
    prefix, ids, mask = _inputs(tg.n_embd)
    out = {}
    for stop in (False, True):
        calls.clear()
        out[stop] = gen.generate_prefixed(td, tg, torch.from_numpy(prefix), torch.from_numpy(ids),
                                          torch.from_numpy(mask),
                                          gen.DecodeParams(**kw, early_stop=stop)).numpy()
        out[(stop, "steps")] = len(calls) - 1      # the prefill is one call
    assert (out[True] == EOS).all()
    np.testing.assert_array_equal(out[True], out[False])
    assert out[(False, "steps")] == 5 and out[(True, "steps")] == 0


def test_early_stop_sampled_ids_equal_the_full_loop(decoders):
    """A sampled decode draws its noise before its first step, so stopping
    early changes no draw: ids equal the full-length loop's, same seed."""
    kw = dict(max_new_tokens=10, num_beams=1, temperature=0.8, top_p=0.9, min_new_tokens=1,
              eos_id=EOS)
    runs = [_port_ids(decoders, {**kw, "early_stop": stop},
                      generator=torch.Generator().manual_seed(7)) for stop in (True, False)]
    np.testing.assert_array_equal(*runs)


def test_beams_done_is_hf_is_done():
    """min(fin_scores) >= max(beam_scores) / t for every video: done before
    step 1 here, not before step 2 (dividing by a longer length raises the
    best attainable score), never without finished hypotheses."""
    scores = torch.tensor([[-2.0, -3.0], [-1.0, -4.0]])
    fin = torch.tensor([[-1.5, -1.8], [-0.7, -0.8]])
    assert gen.beams_done(scores, fin, 1)
    assert not gen.beams_done(scores, fin, 2)
    assert not gen.beams_done(scores, torch.full((2, 2), float("-inf")), 5)


# ---- the split-cache K=1 step ---------------------------------------------


@pytest.mark.parametrize("deferred", [False, True])
def test_sample_step_logits_match_jax(decoders, deferred):
    """Four split-cache steps (gpt2_sample_step after a split prefill) on
    fixed tokens: logits within 1e-5 of the JAX step's."""
    jd, jg, td, tg = decoders
    jg = dataclasses.replace(jg, sample_split_cache=True, deferred_cache_write=deferred)
    tg = dataclasses.replace(tg, sample_split_cache=True, deferred_cache_write=deferred)
    prefix, ids, mask = _inputs(tg.n_embd)
    tok = np.asarray(jd["wte"])[ids]
    emb = np.concatenate([prefix, tok], axis=1)
    pmask = np.concatenate([np.ones((2, 4), np.int32), mask], axis=1)
    s0, n = emb.shape[1], 4
    jwt = jg2.lm_head_t(jd, jg)
    (_, _, _, _), jc, jv, jlen = jgen._prefill(jd, jg, jnp.asarray(emb), s0, jnp.asarray(pmask),
                                               cache_layout="split", wte_t=jwt,
                                               return_stats=True)
    jgc = jg2.init_cache(jg, 2, n, layout="beam_gen")
    twt = g2.lm_head_t(td, tg)
    _, tc, tv, tlen = gen._prefill(td, tg, torch.from_numpy(emb), s0, torch.from_numpy(pmask),
                                   twt, split=True, row_stats=False)
    tgc = g2.init_cache(tg, 2, n, "cpu", layout="beam_gen")
    v = tg.vocab_size
    for t, token in enumerate((5, 9, 9, 30)):
        (jl, _, _, _), jgc = jg2.gpt2_sample_step(
            jd, jd["wte"][jnp.full((2,), token)], jlen + t, jc, jv, jgc, jnp.int32(t), jg,
            wte_t=jwt, return_stats=True)
        (tl, _, _, _), tgc = g2.gpt2_sample_step(
            td, td["wte"][torch.full((2,), token)], tlen + t, tc, tv, tgc, t, tg, twt)
        np.testing.assert_allclose(tl[:, :v].numpy(), np.asarray(jl)[:, :v], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("deferred", [False, True])
def test_split_cache_greedy_ids_match_contiguous_and_jax(decoders, deferred):
    kw = dict(max_new_tokens=8, num_beams=1, min_new_tokens=2, eos_id=EOS)
    split = {"sample_split_cache": True, "deferred_cache_write": deferred}
    got = _port_ids(decoders, kw, split)
    np.testing.assert_array_equal(got, _jax_ids(decoders, kw, split))
    np.testing.assert_array_equal(got, _port_ids(decoders, kw,
                                                 {"deferred_cache_write": deferred}))


def test_split_cache_is_off_under_a_fused_decode_switch(decoders, monkeypatch):
    """The JAX package's rule: with use_pallas_decode set the split cache is
    not taken (its step never runs)."""
    monkeypatch.setattr(g2, "gpt2_sample_step", None)
    kw = dict(max_new_tokens=4, num_beams=1, min_new_tokens=2, eos_id=EOS)
    got = _port_ids(decoders, kw, {"sample_split_cache": True, "use_pallas_decode": True})
    np.testing.assert_array_equal(got, _port_ids(decoders, kw))


def test_split_cache_sampled_ids_equal_contiguous(decoders):
    kw = dict(max_new_tokens=8, num_beams=1, temperature=0.9, top_p=0.9, min_new_tokens=2,
              eos_id=EOS)
    runs = [_port_ids(decoders, kw, cfg, generator=torch.Generator().manual_seed(3))
            for cfg in ({"sample_split_cache": True}, {})]
    np.testing.assert_array_equal(*runs)


# ---- the full-vocab processor chain ----------------------------------------


def _scores(seed, b=3, v=1000, n=8, logp=False):
    """Scores [B, Vp] with -inf pad columns (raw logits, or log-softmax
    ones), the generated buffer, and its tokens made competitive."""
    rng = np.random.RandomState(seed)
    vp = -(-v // 128) * 128
    x = rng.randn(b, vp).astype(np.float32) * 3
    generated = rng.randint(0, 20, (b, n)).astype(np.int64)
    generated[:, 3:6] = generated[:, 0:3]          # a repeated trigram for the n-gram ban
    x[:, :20] += 4.0
    x[:, v:] = -np.inf
    if logp:
        x = np.array(jax.nn.log_softmax(jnp.asarray(x), axis=-1))
    return x, generated


PROCESSORS = {
    "repetition_penalty_0.9": (lambda m, x, g, t: m.apply_repetition_penalty(x, g, t, 0.9)),
    "repetition_penalty_1.3": (lambda m, x, g, t: m.apply_repetition_penalty(x, g, t, 1.3)),
    "no_repeat_ngram_3": (lambda m, x, g, t: m.apply_no_repeat_ngram(x, g, t, 3)),
    "no_repeat_ngram_2": (lambda m, x, g, t: m.apply_no_repeat_ngram(x, g, t, 2)),
    "min_new_tokens": (lambda m, x, g, t: m.apply_min_new_tokens(x, t, 8, 999)),
    "top_k": (lambda m, x, g, t: m.apply_top_k(x, 40)),
    "top_k_top_p": (lambda m, x, g, t: m.apply_top_k_top_p(x, 40, 0.8)),
    "top_k_0_top_p": (lambda m, x, g, t: m.apply_top_k_top_p(x, 0, 0.8)),
    "top_p": (lambda m, x, g, t: m.apply_top_p(x, 0.9)),
    "top_p_cap_16": (lambda m, x, g, t: m.apply_top_p(x, 0.99, nucleus_cap=16)),
}


@pytest.mark.parametrize("t", [0, 7])
@pytest.mark.parametrize("logp", [False, True])
@pytest.mark.parametrize("name", sorted(PROCESSORS))
def test_full_vocab_processors_match_jax(name, logp, t):
    x, generated = _scores(seed=t + 3, logp=logp)
    fn = PROCESSORS[name]
    want = np.asarray(fn(jlp, jnp.asarray(x), jnp.asarray(generated.astype(np.int32)),
                         jnp.int32(t)))
    got = fn(lp, torch.from_numpy(x), torch.from_numpy(generated), t).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-5)
    assert np.isneginf(got[:, 1000:]).all()          # padded columns stay -inf


@pytest.mark.parametrize("k", [1, 50, 200])
def test_exact_topk_without_window_maxima_matches_jax(k):
    x, _ = _scores(seed=11)
    x = x[:, :1000]                                  # not a multiple of the window
    tv, ti = lp.exact_topk(torch.from_numpy(x), k)
    jv, ji = jlp.exact_topk(jnp.asarray(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("top_k", [0, 40])
@pytest.mark.parametrize("t", [0, 6])
def test_full_vocab_sample_select_same_noise_same_token(top_k, t):
    """repetition_penalty 0.9 sampling (top_k 40: the k-way draw; top_k 0:
    the draw over the whole vocabulary) given the Gumbel noise the JAX
    package draws: the same tokens."""
    x, generated = _scores(seed=t)
    kw = dict(num_beams=1, temperature=0.8, top_p=0.9, top_k=top_k, repetition_penalty=0.9,
              no_repeat_ngram_size=3, min_new_tokens=8, eos_id=999)
    rng = jax.random.PRNGKey(t)
    _, sub = jax.random.split(rng)
    width = top_k or x.shape[1]
    noise = np.array(jax.random.gumbel(sub, (3, width), jnp.float32))
    finished = np.array([False, True, False])
    jtok, _, _, _ = jgen.sample_select(jnp.asarray(x), jnp.asarray(generated.astype(np.int32)),
                                       jnp.asarray(finished), jnp.int32(t),
                                       jgen.DecodeParams(**kw), rng)
    tok, _, _ = gen.sample_select(torch.from_numpy(x), torch.from_numpy(generated),
                                  torch.from_numpy(finished), t, gen.DecodeParams(**kw), None,
                                  wmax=None, noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_top_k_0_sampling_distribution_matches_jax():
    """20,000 draws of the top_k = 0 policy (temperature 0.8, top_p 0.9,
    repetition_penalty 0.9) from the generator against the JAX package's
    processed softmax."""
    draws, v = 20000, 1000
    x, generated = _scores(seed=21, b=1, v=v)
    kw = dict(num_beams=1, temperature=0.8, top_p=0.9, top_k=0, repetition_penalty=0.9,
              no_repeat_ngram_size=3, min_new_tokens=8, eos_id=999)
    jdp = jgen.DecodeParams(**kw)
    proc = jgen._process_logits(jnp.asarray(x), jnp.asarray(generated.astype(np.int32)),
                                jnp.int32(6), jdp)
    proc = jlp.apply_top_p(jlp.apply_temperature(proc, 0.8), 0.9)
    want = np.asarray(jax.nn.softmax(proc, axis=-1))[0]
    rows = torch.from_numpy(np.repeat(x, draws, axis=0))
    tok, _, _ = gen.sample_select(rows, torch.from_numpy(np.repeat(generated, draws, axis=0)),
                                  torch.zeros(draws, dtype=torch.bool), 6,
                                  gen.DecodeParams(**kw), torch.Generator().manual_seed(0),
                                  wmax=None)
    freq = np.bincount(tok.numpy(), minlength=x.shape[1]) / draws
    assert freq[want == 0].sum() == 0
    assert 10 <= (want > 0).sum() <= 100              # a nucleus of some tens of tokens
    assert np.abs(freq - want).max() < 0.015
    assert 0.5 * np.abs(freq - want).sum() < 0.03


@pytest.mark.parametrize("beams", [1, 3, 5])
def test_repetition_penalty_below_1_ids_match_jax(decoders, beams):
    kw = dict(max_new_tokens=8, num_beams=beams, min_new_tokens=2, eos_id=EOS,
              repetition_penalty=0.9)
    np.testing.assert_array_equal(_port_ids(decoders, kw), _jax_ids(decoders, kw))


def test_full_vocab_policies_in_the_unified_decode(decoders):
    """A full-vocab beam group, a full-vocab greedy group, a top_k = 0
    sampled group and a candidate-path beam group in one unified loop:
    ids equal ``generate_prefixed`` group by group (one generator seed)."""
    _, _, td, tg = decoders
    base = dict(max_new_tokens=8, min_new_tokens=2, eos_id=EOS)
    dps = (gen.DecodeParams(num_beams=3, repetition_penalty=0.9, **base),
           gen.DecodeParams(num_beams=1, repetition_penalty=0.9, **base),
           gen.DecodeParams(num_beams=1, temperature=0.8, top_p=0.9, top_k=0, **base),
           gen.DecodeParams(num_beams=3, **base))
    prompts = [_prompts(p) for p in ([[3], [9, 11, 4]], [[5]], [[20, 7]], [[8, 8]])]
    prefix = torch.from_numpy((np.random.RandomState(2).randn(2, 4, tg.n_embd) * 0.1)
                              .astype(np.float32))
    got = unified.generate_unified(td, tg, prefix, prompts, dps, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    for (ids, mask), dp, ids_u in zip(prompts, dps, got):
        v = prefix.shape[0]
        want = gen.generate_prefixed(td, tg, prefix.repeat_interleave(ids.shape[0], dim=0),
                                     ids.repeat(v, 1), mask.repeat(v, 1), dp, g)
        np.testing.assert_array_equal(ids_u.numpy(), want.numpy())


# ---- through the engine ------------------------------------------------------


def _engine(tiny_cfg, port_params, seed=0, **compile_kw):  # noqa: F811
    cfg = default_inference_config(ckpt="missing.pt", num_frames=2, image_size=32)
    cfg = dataclasses.replace(cfg, compile=dataclasses.replace(cfg.compile, **compile_kw))
    eng = InferenceEngine(cfg, params=port_params, seed=seed, device="cpu",
                          model_cfg=dataclasses.replace(port_cfg(tiny_cfg), gpt2=dataclasses.replace(
                              port_cfg(tiny_cfg).gpt2,
                              sample_split_cache=cfg.compile.sample_split_cache)))
    eng.tokenizer = WordTok()
    return eng


def _video(seed=5):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, 255, (1, 2, 3, 32, 32)).astype(np.uint8))


def test_engine_passes_the_two_switches_through(tiny_cfg, port_params):  # noqa: F811
    from video_caption_tpu_torch.engine import model_config_from_inference

    cfg = default_inference_config(ckpt="missing.pt", num_frames=2, image_size=32)
    cfg = dataclasses.replace(cfg, compile=dataclasses.replace(
        cfg.compile, early_stop_decode=True, sample_split_cache=True))
    assert model_config_from_inference(cfg).gpt2.sample_split_cache
    eng = _engine(tiny_cfg, port_params, early_stop_decode=True)
    assert eng._decode_params(num_beams=3).early_stop
    assert all(dp.early_stop for dp, *_ in eng._decode_groups())
    assert not eng._unified_eligible(eng._decode_groups(), fused_program=True)
    assert not eng._serves_on_program(_video())
    assert not _engine(tiny_cfg, port_params)._decode_params().early_stop


def test_engine_logs_the_switches_it_does_not_honour(tiny_cfg, port_params, caplog):  # noqa: F811
    with caplog.at_level("INFO", logger="video_caption_tpu_torch.engine"):
        _engine(tiny_cfg, port_params, early_stop_decode=True)
    text = " ".join(r.message for r in caplog.records)
    # the 4:2:0 wire and the overlapped upload are honoured now: no line
    assert "yuv420_wire" not in text and "overlap_single_upload" not in text
    assert "early_stop_decode" in text and "eagerly" in text


def test_early_stop_engine_matches_the_jax_engine(tiny_cfg, tiny_params, port_params,  # noqa: F811
                                                  tmp_path):
    """Beam presets with early stop: the JAX engine's results; and the
    port's own full-length engine's ids."""
    from PIL import Image

    rng = np.random.RandomState(8)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(
            tmp_path / f"frame_{i:05d}.jpg")
    names = dict(preset1="precise", preset2="detailed", preset3="precise",
                 prompt3="Another prompt:")
    jcfg = jax_default_config(ckpt="missing.pt", num_frames=2, image_size=32, **names)
    jcfg = dataclasses.replace(jcfg, compile=dataclasses.replace(jcfg.compile,
                                                                 early_stop_decode=True))
    jax_engine = JaxEngine(jcfg, params=tiny_params, model_cfg=tiny_cfg)
    jax_engine.tokenizer = WordTok()
    cfg = default_inference_config(ckpt="missing.pt", num_frames=2, image_size=32, **names)
    engines = []
    for stop in (True, False):
        c = dataclasses.replace(cfg, compile=dataclasses.replace(cfg.compile,
                                                                 early_stop_decode=stop))
        eng = InferenceEngine(c, params=port_params, model_cfg=port_cfg(tiny_cfg), device="cpu")
        eng.tokenizer = WordTok()
        engines.append(eng)
    assert engines[0].infer(str(tmp_path)).to_api_dict() == \
        jax_engine.infer(str(tmp_path)).to_api_dict()
    video = engines[0].load_video(str(tmp_path))
    for a, b in zip(engines[0].request_ids(video), engines[1].request_ids(video)):
        np.testing.assert_array_equal(a, b)


def test_split_cache_engine_ids_equal_the_default_engine(tiny_cfg, port_params):  # noqa: F811
    """Core presets (the sampled group included), one seed: the split-cache
    engine's request ids equal the default engine's, grouped and unified."""
    video = _video()
    for unified_on in (True, False):
        a = _engine(tiny_cfg, port_params, seed=2, sample_split_cache=True,
                    unified_fused_request=unified_on)
        b = _engine(tiny_cfg, port_params, seed=2, unified_fused_request=unified_on)
        for x, y in zip(a.request_ids(video), b.request_ids(video)):
            np.testing.assert_array_equal(x, y)
