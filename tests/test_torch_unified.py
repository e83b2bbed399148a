"""The port's unified mixed-policy decode (decode/unified.py) and the engine's
request program that runs it, on the CPU at the conftest's tiny geometry in
f32.

Held three ways: against the port's grouped decode (``generate_prefixed``
per group, the cases of tests/test_unified_decode.py plus two sampled
groups), ids identical, sampled groups included (both draw each sampled
group's noise at its turn, in group order, from one generator); against the
JAX ``generate_unified`` on the same weights, beam and greedy groups
identical (the random streams of the two packages differ); and through the
engine, with ``unified_fused_request`` on and off, and against the JAX
engine."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_aot import WordTok, _engine, _video, port_cfg, port_params  # noqa: F401
from video_caption_tpu.config import default_inference_config as jax_default_config
from video_caption_tpu.decode.generate import DecodeParams as JaxDecodeParams
from video_caption_tpu.decode.unified import generate_unified as jax_generate_unified
from video_caption_tpu.engine import InferenceEngine as JaxEngine
from video_caption_tpu_torch.decode import unified
from video_caption_tpu_torch.decode.generate import DecodeParams, generate_prefixed

BEAM3 = DecodeParams(max_new_tokens=8, num_beams=3, min_new_tokens=2, eos_id=127)
SAMPLED = DecodeParams(max_new_tokens=8, num_beams=1, temperature=0.9, top_p=0.9, top_k=50,
                       min_new_tokens=2, eos_id=127)
CASES = {
    # the core presets' shape: a 2-slot beam group and a sampled group
    "beam_plus_sampled": (([[3], [9, 11, 4]], [[20, 7]]), (BEAM3, SAMPLED)),
    # the serving shape: groups freeze at their own horizon in the shared loop
    "differing_horizons_and_widths": (
        ([[3]], [[9, 11, 4]], [[20, 7]]),
        (dataclasses.replace(BEAM3, max_new_tokens=6),
         DecodeParams(max_new_tokens=10, num_beams=2, min_new_tokens=2, eos_id=127),
         dataclasses.replace(SAMPLED, max_new_tokens=6, temperature=0.8, top_p=0.85))),
    # greedy rows (num_beams 1, temperature 1) ride the k=0 row of a K_max=4 block
    "greedy_with_beam": (([[5, 6]], [[8]]),
                         (DecodeParams(max_new_tokens=7, num_beams=1, min_new_tokens=2,
                                       eos_id=127),
                          DecodeParams(max_new_tokens=7, num_beams=4, min_new_tokens=2,
                                       eos_id=127))),
    # two sampled groups (natural + safe_sample): their draws must not interleave
    "two_sampled_groups_and_a_beam_group": (
        ([[20, 7]], [[3], [9, 11, 4]], [[5, 6, 2]]),
        (SAMPLED, BEAM3, dataclasses.replace(SAMPLED, max_new_tokens=5, temperature=0.7,
                                             top_p=0.95, top_k=20))),
}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Many small ops: under several test workers, torch's intra-op thread
    pools would oversubscribe the cores (results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prompts(prompt_lists, pad_id=127):
    """Engine-style LEFT-padded (ids, mask) of one policy group."""
    max_len = max(len(p) for p in prompt_lists)
    ids = np.full((len(prompt_lists), max_len), pad_id, np.int64)
    mask = np.zeros((len(prompt_lists), max_len), np.int32)
    for row, p in enumerate(prompt_lists):
        ids[row, max_len - len(p):] = p
        mask[row, max_len - len(p):] = 1
    return torch.from_numpy(ids), torch.from_numpy(mask)


@pytest.fixture(scope="module")
def setup(tiny_cfg, port_params):  # noqa: F811
    rng = np.random.RandomState(0)
    prefix = rng.randn(3, 4, tiny_cfg.gpt2.n_embd).astype(np.float32) * 0.1
    return port_params["decoder"], port_cfg(tiny_cfg).gpt2, prefix


def _grouped(decoder, gcfg, prefix, prompts, dps, seed):
    """The engine's per-group path: one generator, groups in order."""
    gen = torch.Generator().manual_seed(seed)
    v = prefix.shape[0]
    return [generate_prefixed(decoder, gcfg, prefix.repeat_interleave(ids.shape[0], dim=0),
                              ids.repeat(v, 1), mask.repeat(v, 1), dp, gen).numpy()
            for (ids, mask), dp in zip(prompts, dps)]


def _unified(decoder, gcfg, prefix, prompts, dps, seed):
    out = unified.generate_unified(decoder, gcfg, prefix, prompts, dps,
                                   torch.Generator().manual_seed(seed))
    return [x.numpy() for x in out]


@pytest.mark.parametrize("videos", [3, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_unified_equals_grouped(setup, case, videos):
    """Ids identical group by group, sampled groups included, for one video
    and for three."""
    decoder, gcfg, prefix = setup
    prompt_lists, dps = CASES[case]
    prompts = [_prompts(p) for p in prompt_lists]
    prefix = torch.from_numpy(prefix[:videos])
    got = _unified(decoder, gcfg, prefix, prompts, dps, seed=5)
    want = _grouped(decoder, gcfg, prefix, prompts, dps, seed=5)
    for g, (u, r) in enumerate(zip(got, want)):
        assert u.shape == (videos * prompts[g][0].shape[0], dps[g].max_new_tokens)
        np.testing.assert_array_equal(u, r, err_msg=f"group {g} ({dps[g]}) diverged")
    sampled = [u for u, dp in zip(got, dps) if dp.do_sample]
    assert all(len(np.unique(u)) > 2 for u in sampled)      # not vacuous


def test_unified_equals_grouped_with_the_deferred_cache_write(setup):
    """beam_attention's deferred mode over the unified layout (dead and
    sampled rows with identity ancestry), against the grouped decode with
    the same switch."""
    decoder, gcfg, prefix = setup
    gcfg = dataclasses.replace(gcfg, deferred_cache_write=True)
    prompt_lists, dps = CASES["differing_horizons_and_widths"]
    prompts = [_prompts(p) for p in prompt_lists]
    prefix = torch.from_numpy(prefix)
    for u, r in zip(_unified(decoder, gcfg, prefix, prompts, dps, 2),
                    _grouped(decoder, gcfg, prefix, prompts, dps, 2)):
        np.testing.assert_array_equal(u, r)


def test_unified_draws_each_sampled_group_at_its_turn(setup):
    """Two sampled groups take their noise in group order, all steps at
    once: swapping the groups swaps whose draws come first, so each group's
    ids follow its position, as in the grouped decode."""
    decoder, gcfg, prefix = setup
    prompts = [_prompts([[20, 7]]), _prompts([[5, 6, 2]])]
    dps = (SAMPLED, dataclasses.replace(SAMPLED, temperature=0.7))
    prefix = torch.from_numpy(prefix[:1])
    a = _unified(decoder, gcfg, prefix, prompts, dps, seed=9)
    b = _unified(decoder, gcfg, prefix, prompts[::-1], dps[::-1], seed=9)
    assert not np.array_equal(a[0], b[1])     # the first group drew first
    np.testing.assert_array_equal(b[0], _grouped(decoder, gcfg, prefix, prompts[::-1],
                                                 dps[::-1], 9)[0])


@pytest.mark.parametrize("case", ["beam_plus_sampled", "differing_horizons_and_widths",
                                  "greedy_with_beam"])
def test_beam_and_greedy_groups_equal_the_jax_unified_decode(tiny_cfg, tiny_params, setup, case):
    """On weights carried across by params_from_jax_numpy: every beam and
    greedy group's ids equal the JAX generate_unified's."""
    decoder, gcfg, prefix = setup
    prompt_lists, dps = CASES[case]
    prompts = [_prompts(p) for p in prompt_lists]
    got = _unified(decoder, gcfg, torch.from_numpy(prefix), prompts, dps, seed=1)
    jdps = tuple(JaxDecodeParams(**dataclasses.asdict(dp)) for dp in dps)
    keys = tuple(jax.random.fold_in(jax.random.PRNGKey(1), g) for g in range(len(dps)))
    want = jax_generate_unified(
        tiny_params["decoder"], tiny_cfg.gpt2, jnp.asarray(prefix),
        tuple((jnp.asarray(ids.numpy().astype(np.int32)), jnp.asarray(mask.numpy()))
              for ids, mask in prompts), jdps, keys)
    checked = 0
    for g, dp in enumerate(dps):
        if not dp.do_sample:
            np.testing.assert_array_equal(got[g], np.asarray(want[g]), err_msg=f"group {g}")
            checked += 1
    assert checked >= 1


def test_engine_beam_presets_equal_the_jax_engine(tiny_cfg, tiny_params, port_params,  # noqa: F811
                                                  frames_dirs):
    """Beam-only presets in two policy groups (unified on in both engines,
    the JAX default): the same ``to_api_dict()``."""
    names = dict(preset1="precise", preset2="detailed", preset3="precise",
                 prompt3="Another prompt:")
    jax_engine = JaxEngine(jax_default_config(ckpt="missing.pt", num_frames=2, image_size=32,
                                              **names), params=tiny_params, model_cfg=tiny_cfg)
    jax_engine.tokenizer = WordTok()
    port = _engine(tiny_cfg, port_params, **names)
    _, groups = port._fused_infer_program()
    assert port._unified_eligible(groups, fused_program=True) and len(groups) == 2
    for d in frames_dirs[:2]:
        got, want = port.infer(d).to_api_dict(), jax_engine.infer(d).to_api_dict()
        assert got == want
        assert got["S1"] != "Someone is in the scene."


def test_engine_result_with_unified_on_equals_off(tiny_cfg, port_params, frames_dirs,  # noqa: F811
                                                  monkeypatch):
    """Two engines from one seed, ``unified_fused_request`` on (the default)
    and off, over three requests: the same results, the sampled caption
    included; the one with it on decodes through generate_unified."""
    calls = []
    real = unified.generate_unified
    monkeypatch.setattr(unified, "generate_unified",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    on = _engine(tiny_cfg, port_params, seed=6)
    off = _engine(tiny_cfg, port_params, seed=6, unified_fused_request=False)
    results = [(on.infer(d).to_api_dict(), off.infer(d).to_api_dict()) for d in frames_dirs]
    assert len(calls) == len(frames_dirs)
    for got, want in results:
        assert got == want
    assert len({r[0]["S3"] for r in results}) > 1


@pytest.mark.parametrize("overrides,fused,eligible", [
    ({}, True, True),                                       # the default single request
    ({}, False, False),                                     # the batch path: unified_decode off
    ({"unified_decode": True}, False, True),
    ({"unified_fused_request": False}, True, False),
    ({"use_pallas_decode_layer": True}, True, False),       # another cache layout
    ({"deferred_decode_cache_write": True}, True, True),
    ({"preset2": "precise", "preset3": "precise"}, True, False),   # one policy group
])
def test_unified_eligibility(tiny_cfg, port_params, overrides, fused,  # noqa: F811
                             eligible):
    """The JAX engine's rule: two or more groups, no decode_layer, no early
    stop; the request program follows unified_decode or
    unified_fused_request, the batch program unified_decode alone."""
    decode = "use_pallas_decode_layer" if overrides.pop("use_pallas_decode_layer", False) \
        else "deferred_decode_cache_write" if overrides.pop("deferred_decode_cache_write", False) \
        else "default"
    eng = _engine(tiny_cfg, port_params, decode, **overrides)
    _, groups = eng._fused_infer_program()
    assert eng._unified_eligible(groups, fused_program=fused) is eligible


@pytest.fixture(scope="module")
def frames_dirs(tmp_path_factory):
    from PIL import Image

    rng = np.random.RandomState(23)
    dirs = []
    for v, count in enumerate((2, 5, 3)):
        d = tmp_path_factory.mktemp(f"uni{v}")
        for i in range(count):
            Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(
                d / f"frame_{i:05d}.jpg")
        dirs.append(str(d))
    return dirs


def test_request_program_ids_equal_the_batch_program_ids(tiny_cfg, port_params):  # noqa: F811
    """One video through the request program (unified) and through the
    batch program (grouped, unified_decode off), two engines from one seed:
    identical ids in every group."""
    video = _video(3)
    a, b = (_engine(tiny_cfg, port_params, seed=8) for _ in range(2))
    fused, groups = a._fused_infer_program()
    batch, groups_b = b._batch_infer_program()
    assert [g[1] for g in groups] == [g[1] for g in groups_b]
    for x, y in zip(fused(video), batch(video)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
